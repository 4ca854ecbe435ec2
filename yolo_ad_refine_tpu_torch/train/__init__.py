"""Training: assigner, loss, optimizer, train step and trainer."""
