"""Training: losses' step logic, optimizers and the train state."""
