from repro_torch.data.loader import to_device
from repro_torch.data.synthetic import ANSWER, N_RESERVED, lm_stream, needle_qa

__all__ = ["lm_stream", "needle_qa", "N_RESERVED", "ANSWER", "to_device"]
