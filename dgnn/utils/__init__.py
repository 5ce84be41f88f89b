from .timing import (run_epochs, time_epoch_loop, device_peak_memory_mb,
                     peak_memory_mb)
from .checkpoint import load_checkpoint, save_checkpoint
from .compile_cache import enable_compile_cache
from .logging import append_csv_row

__all__ = ["run_epochs", "time_epoch_loop", "device_peak_memory_mb",
           "peak_memory_mb",
           "load_checkpoint", "save_checkpoint", "enable_compile_cache",
           "append_csv_row"]
