from kbmod_tpu_torch.utils.debug_timer import DebugTimer
from kbmod_tpu_torch.utils.logging_utils import Logging

__all__ = ["DebugTimer", "Logging"]
