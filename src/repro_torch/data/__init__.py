"""repro_torch.data"""
