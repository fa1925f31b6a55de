"""Early-exit dense decoder: segments of attention blocks with a ramp
after every segment but the last — every segment boundary is a T-Tamer
node."""

from repro_torch.models.config import (AttnConfig, BlockConfig, ModelConfig,
                                       Segment)

__all__ = ["AttnConfig", "BlockConfig", "ModelConfig", "Segment"]
