"""ChainState checkpoint/resume and metrics observability tests.

SURVEY.md §5: the reference has no checkpointing, but its state-vector IS
the checkpoint; here ChainState.save/load must make a stream bit-resumable.
"""

import json
import pytest

import jax.numpy as jnp
import numpy as np

from solid_dsp_tpu.models.rx_chain import RxChain, RxChainConfig, make_rx_chain, rx_chain_init
from solid_dsp_tpu.streaming.state import ChainState
from solid_dsp_tpu.utils.metrics import MetricsCollector, rssi_db

H100 = "NVIDIA H100 80GB HBM3"


def _tone(n, f, amp=0.1, seed=0):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (amp * np.exp(2j * np.pi * f * k)
            + 0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))


class TestCheckpoint:
    def test_save_load_resumes_bit_identical(self, tmp_path):
        cfg = RxChainConfig(dtype=jnp.complex128, nco_mode="exact",
                            agc_mode="block")
        init, apply = make_rx_chain(cfg)
        x1 = jnp.asarray(_tone(2048, 0.033), dtype=cfg.dtype)
        x2 = jnp.asarray(_tone(2048, 0.033, seed=1), dtype=cfg.dtype)

        # continuous run
        s = init()
        _, s = apply(s, x1)
        ref_out, _ = apply(s, x2)

        # checkpointed run: save after block 1, restore into a fresh state
        p = str(tmp_path / "ckpt.npz")
        s.save(p)
        fresh = rx_chain_init(cfg)
        restored = ChainState.load(p, like=fresh)
        out, _ = apply(restored, x2)

        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref_out))

    def test_state_repr(self):
        cfg = RxChainConfig()
        s = rx_chain_init(cfg)
        r = repr(s)
        assert "ChainState" in r and "agc" in r


class TestMetrics:
    def test_collector_captures_rssi(self):
        chain = RxChain(dtype=jnp.complex64, nco_mode="exact",
                        agc_mode="block", demod="fm")
        lines = []
        mc = MetricsCollector(sink=lambda m: lines.append(m.to_json()))
        x = jnp.asarray(_tone(4096, 0.033, amp=0.05), dtype=jnp.complex64)
        for _ in range(4):
            mc.measure(chain, x)

        assert len(mc.history) == 4
        last = mc.history[-1]
        assert last.n_samples == 4096
        assert last.agc_gain is not None and last.agc_gain > 1.0
        # -26 dB-ish input -> positive RSSI mapping per reference convention
        assert last.rssi_db is not None
        rec = json.loads(lines[-1])
        assert rec["block_index"] == 3
        assert rec["msps"] > 0

    def test_rssi_formula(self):
        # reference: rssi = -20 log10(gain) (agc :442-444)
        assert abs(rssi_db(10.0) + 20.0) < 1e-12
        assert abs(rssi_db(1.0)) < 1e-12


class TestCheckpointValidation:
    """Negative tests: structure drift must fail loudly."""

    def _chain_state(self, taps=8, extra=False):
        import jax.numpy as jnp

        d = dict(nco_theta=jnp.uint32(3),
                 fir_tail=jnp.zeros(taps, jnp.complex128),
                 agc={"gain": jnp.asarray(2.0)})
        if extra:
            d["fm_prev"] = jnp.asarray(0.0 + 0j)
        return ChainState(**d)

    def test_structure_drift_rejected(self, tmp_path):
        p = str(tmp_path / "c.npz")
        self._chain_state().save(p)
        with pytest.raises(ValueError, match="structure mismatch"):
            ChainState.load(p, like=self._chain_state(extra=True))

    def test_shape_drift_rejected(self, tmp_path):
        p = str(tmp_path / "c.npz")
        self._chain_state(taps=8).save(p)
        with pytest.raises(ValueError, match="shape"):
            ChainState.load(p, like=self._chain_state(taps=16))

    def test_dtype_drift_rejected(self, tmp_path):
        import jax.numpy as jnp

        p = str(tmp_path / "c.npz")
        self._chain_state().save(p)
        like = self._chain_state()
        like = like.replace(fir_tail=jnp.zeros(8, jnp.complex64))
        with pytest.raises(ValueError, match="dtype"):
            ChainState.load(p, like=like)

    def test_version_field_saved_and_future_rejected(self, tmp_path):
        import numpy as np

        p = str(tmp_path / "c.npz")
        st = self._chain_state()
        st.save(p)
        data = dict(np.load(p).items())
        assert int(data["__version__"]) == ChainState.CHECKPOINT_VERSION
        data["__version__"] = np.asarray(ChainState.CHECKPOINT_VERSION + 1)
        np.savez(p, **data)
        with pytest.raises(ValueError, match="newer"):
            ChainState.load(p, like=st)

    def test_matching_roundtrip_still_works(self, tmp_path):
        import numpy as np

        p = str(tmp_path / "c.npz")
        st = self._chain_state()
        got = ChainState.load(str(p), like=st) if st.save(p) else \
            ChainState.load(p, like=st)
        np.testing.assert_array_equal(np.asarray(got.fir_tail),
                                      np.asarray(st.fir_tail))
        assert float(got.agc["gain"]) == 2.0


class TestRoofline:
    def test_memory_bound_classification(self):
        from solid_dsp_tpu.utils.profiling import fir_workload, roofline

        flops, byts = fir_workload(1 << 20, 64)
        # 2e11 samples/s against the H100 row at TF32 rates: 32 flop/B
        # is under the TF32 ridge (~148 flop/B), so bytes bound
        r = roofline("fir", seconds=(1 << 20) / 200e9, flops=flops,
                     bytes_moved=byts, device_kind=H100, compute="tf32")
        assert r.bound == "memory"
        assert 0.0 < r.frac_memory <= 2.0
        assert "memory-bound" in repr(r)

    def test_compute_bound_classification(self):
        from solid_dsp_tpu.utils.profiling import roofline

        # high arithmetic intensity (1000 flop/B) at 20 TFLOP/s: compute
        r = roofline("matmul", seconds=0.05, flops=1e12, bytes_moved=1e9,
                     device_kind=H100)
        assert r.bound == "compute"
        assert r.frac_compute > r.frac_memory

    def test_unknown_device_raises(self):
        from solid_dsp_tpu.utils.profiling import chip_peaks, roofline

        with pytest.raises(KeyError, match="no published peaks"):
            chip_peaks("NVIDIA A100-SXM4-80GB")
        with pytest.raises(KeyError):
            roofline("x", seconds=1.0, flops=1.0, bytes_moved=1.0,
                     device_kind="cpu")

    def test_default_device_kind_is_looked_up(self):
        # the CPU test backend has no published peaks: an error, not a
        # silent fallback to another chip's row
        from solid_dsp_tpu.utils.profiling import chip_peaks

        with pytest.raises(KeyError):
            chip_peaks()

    def test_h100_peaks_and_compute_kinds(self):
        from solid_dsp_tpu.utils.profiling import chip_peaks, roofline

        pk = chip_peaks(H100)
        assert pk == {"gbps_hbm": 3350.0, "gflops_bf16": 989000.0,
                      "gflops_tf32": 495000.0, "gflops_f32": 67000.0}
        # 1e12 flop in 1 s: share of the f32 vs bf16 peaks
        r32 = roofline("m", 1.0, 1e12, 1.0, device_kind=H100)
        r16 = roofline("m", 1.0, 1e12, 1.0, device_kind=H100,
                       compute="bf16")
        assert r32.frac_compute == pytest.approx(1e3 / 67000.0)
        assert r16.frac_compute == pytest.approx(1e3 / 989000.0)

    def test_fft_workload_model(self):
        from solid_dsp_tpu.utils.profiling import fft_workload

        flops, byts = fft_workload(4096, 4096)
        assert flops == 5.0 * 4096 * 4096 * 12
        assert byts == 2.0 * 8.0 * 4096 * 4096
