"""Which engine runs on which backend.

Every trace-time choice that depends on the device is made here, so one
module says what an NVIDIA GPU (XLA:GPU, ``jax.default_backend() ==
"gpu"``) runs and what the CPU runs.  Any other backend takes the CPU's
choices, which are the portable ones.

* FIR correlation: banded-Toeplitz ``dot_general`` on the GPU (one GEMM
  per block, cuBLAS or XLA's GEMM emitter), ``conv_general_dilated`` on
  the CPU.
* ``"x3"`` dot precision: the TF32_TF32_F32_X3 algorithm on the GPU
  (each float32 operand split into a high and a low TF32 part, three
  tensor-core passes), full float32 (``Precision.HIGHEST``) on the CPU,
  whose dot emitter rejects such algorithms for small dots.  XLA:GPU
  also accepts BF16_BF16_F32_X3, but its ~16-bit operand split leaves
  the FM chain below the 90 dB x3 gate on an H100 (chip_smoke.py).
* NCO ``"lut"`` mode: the CPU reads the 1024-entry table (bit-exact
  parity with the reference); the GPU evaluates the same quantized angle
  with ``sin`` (~1 ulp from the table) instead of a full-rate gather.
"""

from __future__ import annotations

import jax

__all__ = ["on_gpu", "fir_uses_toeplitz", "x3_precision",
           "nco_reads_lut_table"]


def on_gpu() -> bool:
    """True when the default JAX backend is a GPU."""
    return jax.default_backend() == "gpu"


def fir_uses_toeplitz() -> bool:
    """FIR correlations run as banded-Toeplitz GEMMs (GPU) or as XLA
    convolutions (CPU)."""
    return on_gpu()


def x3_precision():
    """The XLA dot precision behind the framework's ``"x3"`` name."""
    if on_gpu():
        return jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3
    return jax.lax.Precision.HIGHEST


def nco_reads_lut_table() -> bool:
    """NCO ``"lut"`` mode reads the sine table (CPU) or evaluates the
    table's quantized angle directly (GPU)."""
    return not on_gpu()
