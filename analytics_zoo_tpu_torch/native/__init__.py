"""Native host runtime (port of ``analytics_zoo_tpu.native``): ctypes
bindings over the port's copy of the C++ runtime,
``analytics_zoo_tpu_torch/csrc/zoo_native.cpp`` — the mmap arena, the
threaded row gather and the sample cache. It builds with ``g++`` at first
use and keeps working on numpy where no compiler is present
(``native_available()`` is False).
"""

from .lib import (HostArena, NativeSampleCache, gather_rows, native_available,
                  num_gather_threads)

__all__ = ["HostArena", "NativeSampleCache", "gather_rows", "native_available",
           "num_gather_threads"]
