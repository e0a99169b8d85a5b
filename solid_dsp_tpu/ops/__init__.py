"""Compute ops: dot-product, FIR/IIR filters, FFT engine, NCO, AGC, correlators.

Every op is a pure block transform ``(params, state, x) -> (y, state)`` plus a
thin stateful wrapper class mirroring the reference's streaming API.
"""

from . import dotprod  # noqa: F401
from . import fir  # noqa: F401
from . import iir  # noqa: F401
from . import nco  # noqa: F401
from . import agc  # noqa: F401
from . import fft  # noqa: F401
from . import autocorr  # noqa: F401
from . import trig_transforms  # noqa: F401
from . import czt  # noqa: F401
from . import quantize  # noqa: F401
from . import resample  # noqa: F401
from . import gridresample  # noqa: F401
from . import kalman  # noqa: F401
from . import linrec  # noqa: F401
from . import wavelet  # noqa: F401
from . import zerophase  # noqa: F401
