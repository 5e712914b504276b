"""Training: the APD loss, Adam + OneCycle, the per-batch steps and the
device-resident epochs."""
