from llamago_tpu_torch.utils.console import colorize, log

__all__ = ["colorize", "log"]
