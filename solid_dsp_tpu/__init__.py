"""solid_dsp_tpu — a JAX DSP/SDR framework for an NVIDIA GPU.

A JAX/XLA framework with the capabilities of the Rust
streaming-DSP library ``juliantos/solid-dsp``, re-designed for an
accelerator:

* every component is a pure block transform ``(state, x_block) -> (y_block, state)``
  suitable for ``jax.jit``, ``lax.scan`` over blocks and ``shard_map`` over device
  meshes — instead of the reference's sample-at-a-time mutable-state objects;
* inner loops (FIR taps, polyphase banks, DFT codelets) map to matmuls or
  XLA convolutions/FFTs (cuBLAS/cuFFT on the GPU);
* streaming state (filter tails, IIR biquad state, NCO phase, AGC gain,
  decimator phase) lives in explicit pytree carries, which double as the
  checkpoint format and the device-halo payload for multi-chip execution.

Module map (reference parity noted in each module's docstring):

=====================  =======================================================
``design``             firdes / iirdes / windows / polynomial & special math
``ops``                dot-product, FIR (+decim/interp/PFB), IIR (+SOS), FFT
                       engine, NCO, AGC, auto-correlator
``analysis``           group delay, frequency response, ISI/energy metrics
``models``             demodulators & modems (FM, AM, QPSK), rx chains,
                       polyphase channelizer
``parallel``           meshes, halo exchange, sharded chains
``streaming``          ChainState pytrees, block framing, ring buffers
``runtime``            native (C++) runtime bindings: ring buffer, IQ file IO,
                       block pipeline executor
``utils``              profiling / metrics / debug reprs
=====================  =======================================================
"""

__version__ = "0.1.0"

from . import design, ops, analysis, streaming, utils  # noqa: F401

# `models`, `parallel`, `runtime` import jax-heavy / native pieces; they are
# imported lazily by user code to keep `import solid_dsp_tpu` light.
