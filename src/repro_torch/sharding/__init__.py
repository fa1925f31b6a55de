"""repro_torch.sharding"""
