"""repro_torch.examples: end-to-end scripts run as modules."""
