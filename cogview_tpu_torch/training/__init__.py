"""Training: losses, optimizer, loss scaler, train step, checkpoints."""
