"""repro_torch.serving — the segment-wise token step driven by
`repro_torch.strategy`, plus the continuous-batching runtime."""
