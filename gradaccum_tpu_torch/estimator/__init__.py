"""The training harness: Estimator, checkpoints, metrics, run config."""
