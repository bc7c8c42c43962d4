from .columns import *  # noqa: F401,F403
from .stark import CpuStark, CpuStarkImageBound  # noqa: F401
from . import ctl  # noqa: F401
