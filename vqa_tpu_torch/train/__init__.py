"""Training of the port: state, steps, checkpoints, int8 calibration, logging."""
