"""The RL training stack (PyTorch port of `repro.core`).

  policy        Table-2 Conv3D Gaussian policy (+ critic), an nn.Module
  ppo           clip-PPO with GAE (paper hyperparameters)
  rollout       synchronous fleet rollout
  orchestrator  initial-state bank on the device, fleet programs
  runner        training loop with checkpoint/restart
  checkpoints   atomic versioned integrity-checked checkpoints
"""
