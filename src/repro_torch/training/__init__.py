"""repro_torch.training"""
