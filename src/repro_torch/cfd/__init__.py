"""DGSEM compressible Navier-Stokes LES of forced HIT (PyTorch port of
`repro.cfd`): gll, equations, dgsem, solver, spectra, initial, env."""
