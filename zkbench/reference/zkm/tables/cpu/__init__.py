# Frozen copy of zkm_tpu_torch/tables/cpu/__init__.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
from .columns import *  # noqa: F401,F403
from .stark import CpuStark, CpuStarkImageBound  # noqa: F401
from . import ctl  # noqa: F401
