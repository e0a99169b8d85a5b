"""Multi-device sharding tests on a fake 8-device CPU mesh.

SURVEY.md §4: the reference has no multi-node story to imitate; these tests
validate the framework's own sharding contract — sharded outputs must equal
the single-chip block outputs (halo exchange is semantically invisible).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from solid_dsp_tpu import parallel
from solid_dsp_tpu.models.channelizer import PolyphaseChannelizer
from solid_dsp_tpu.models.rx_chain import RxChainConfig, make_rx_chain
from solid_dsp_tpu.ops import fir as fir_ops


needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 fake devices")


def _tone(n, f, amp=1.0, seed=0):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = amp * np.exp(2j * np.pi * f * k) + 0.01 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n)
    )
    return x.astype(np.complex128)


@needs8
@pytest.mark.parametrize("channel,time", [(1, 8), (2, 4), (4, 2)])
def test_sharded_fir_matches_single_chip(channel, time):
    mesh = parallel.make_mesh(channel=channel, time=time)
    ntaps = 33
    taps = jnp.asarray(np.hamming(ntaps) / ntaps, dtype=jnp.complex128)
    C, L = channel * 2, 1024
    x = np.stack([_tone(L, 0.01 * (c + 1), seed=c) for c in range(C)])

    apply_fn = parallel.sharded_fir(taps, mesh)
    tail = fir_ops.fir_init(ntaps, dtype=jnp.complex128, batch_shape=(C,))
    y_shard, tail_shard = apply_fn(tail, jnp.asarray(x))

    # single-chip truth, channel by channel, two sequential blocks to also
    # check the carried tail
    for c in range(C):
        y_ref, _ = fir_ops.fir_apply(taps, tail[c], jnp.asarray(x[c]),
                                     method="matmul")
        np.testing.assert_allclose(np.asarray(y_shard[c]),
                                   np.asarray(y_ref), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(tail_shard),
                               x[:, -(ntaps - 1):], rtol=0, atol=0)

    # second block consumes the carried tail correctly
    x2 = np.stack([_tone(L, 0.01 * (c + 1), seed=100 + c) for c in range(C)])
    y2_shard, _ = apply_fn(tail_shard, jnp.asarray(x2))
    for c in range(C):
        _, t1 = fir_ops.fir_apply(taps, tail[c], jnp.asarray(x[c]),
                                  method="matmul")
        y2_ref, _ = fir_ops.fir_apply(taps, t1, jnp.asarray(x2[c]),
                                      method="matmul")
        np.testing.assert_allclose(np.asarray(y2_shard[c]),
                                   np.asarray(y2_ref), rtol=1e-9, atol=1e-12)


@needs8
def test_sharded_rx_chain_matches_single_chip():
    mesh = parallel.make_mesh(channel=2, time=4)
    cfg = RxChainConfig(dtype=jnp.complex128, agc_mode="block", demod="fm",
                        nco_mode="exact", fused_ddc="off")
    C, L = 4, 2048
    x = np.stack([_tone(L, 0.2 / (2 * np.pi) + 0.001, amp=0.1, seed=c)
                  for c in range(C)])

    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    st = init_s(C)
    out_shard, st2 = apply_s(st, jnp.asarray(x))

    # single-chip truth per channel
    init1, apply1 = make_rx_chain(cfg)
    for c in range(C):
        s1 = init1()
        out_ref, s1b = apply1(s1, jnp.asarray(x[c]))
        np.testing.assert_allclose(np.asarray(out_shard[c]),
                                   np.asarray(out_ref), rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(st2.agc["gain"][c]),
                                   np.asarray(s1b.agc["gain"]), rtol=1e-9)
    assert int(st2.nco_theta) == int(s1b.nco_theta)

    # streaming continuation
    x2 = np.stack([_tone(L, 0.2 / (2 * np.pi) + 0.001, amp=0.1, seed=50 + c)
                   for c in range(C)])
    out2_shard, _ = apply_s(st2, jnp.asarray(x2))
    for c in range(C):
        s1 = init1()
        _, s1b = apply1(s1, jnp.asarray(x[c]))
        out2_ref, _ = apply1(s1b, jnp.asarray(x2[c]))
        np.testing.assert_allclose(np.asarray(out2_shard[c]),
                                   np.asarray(out2_ref), rtol=1e-7, atol=1e-9)


@needs8
@pytest.mark.parametrize("channel,time", [(2, 4), (4, 2)])
def test_sharded_channelizer_matches_single_chip(channel, time):
    mesh = parallel.make_mesh(channel=channel, time=time)
    M, K = 16, 8
    L = M * 64
    x = _tone(L, 3.0 / M, seed=7)

    init, apply_fn = parallel.make_sharded_channelizer(
        M, K, mesh, dtype=jnp.complex128
    )
    tail = init()
    Y_shard, tail2 = apply_fn(tail, jnp.asarray(x))

    ch = PolyphaseChannelizer(M, K, dtype=jnp.complex128)
    Y_ref = ch.execute_block(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(Y_shard), np.asarray(Y_ref),
                               rtol=1e-8, atol=1e-10)

    # second block continues the stream
    x2 = _tone(L, 3.0 / M, seed=8)
    Y2_shard, _ = apply_fn(tail2, jnp.asarray(x2))
    Y2_ref = ch.execute_block(jnp.asarray(x2))
    np.testing.assert_allclose(np.asarray(Y2_shard), np.asarray(Y2_ref),
                               rtol=1e-8, atol=1e-10)


@needs8
def test_halo_primitives():
    mesh = parallel.make_mesh(channel=1, time=8)
    from jax.sharding import PartitionSpec as P

    def f(x):
        h = parallel.left_halo(x, "time")
        last = parallel.from_last_shard(x, "time")
        return h, last

    g = jax.shard_map(f, mesh=mesh, in_specs=P("time"),
                      out_specs=(P("time"), P("time")))
    x = jnp.arange(16.0)
    h, last = g(x)
    # shard i (len 2) receives shard i-1's block; shard 0 gets zeros
    np.testing.assert_array_equal(np.asarray(h)[:2], [0.0, 0.0])
    np.testing.assert_array_equal(np.asarray(h)[2:], np.arange(14.0))
    # every shard sees the last shard's block
    np.testing.assert_array_equal(
        np.asarray(last), np.tile([14.0, 15.0], 8)
    )


@needs8
@pytest.mark.parametrize("demod", ["am", "none", "qpsk"])
def test_sharded_rx_chain_other_demods(demod):
    mesh = parallel.make_mesh(channel=2, time=4)
    cfg = RxChainConfig(dtype=jnp.complex128, agc_mode="block", demod=demod,
                        nco_mode="exact", fused_ddc="off")
    C, L = 2, 1024
    x = np.stack([_tone(L, 0.035, amp=0.1, seed=c) for c in range(C)])

    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    out_shard, _ = apply_s(init_s(C), jnp.asarray(x))

    init1, apply1 = make_rx_chain(cfg)
    for c in range(C):
        out_ref, _ = apply1(init1(), jnp.asarray(x[c]))
        np.testing.assert_allclose(np.asarray(out_shard[c]),
                                   np.asarray(out_ref), rtol=1e-7, atol=1e-9)


@needs8
def test_sharded_equalizer_train_step_matches_single_device():
    """DP+SP training step: sharded loss/grads == single-device values."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from solid_dsp_tpu.ops import fir as fir_ops

    mesh = parallel.make_mesh(channel=2, time=4)
    ntaps, C, L = 9, 4, 512
    opt = optax.sgd(0.1)
    taps0 = jnp.zeros(ntaps, jnp.complex64).at[ntaps // 2].set(1.0)

    def train_step(taps, opt_state, tail, xb, db):
        x_ext = jnp.concatenate([tail, xb], axis=-1)

        def loss_fn(w):
            r = fir_ops.conv1d_mxu(x_ext, w) - db
            return jnp.mean(jnp.real(r * jnp.conj(r)))

        loss, g = jax.value_and_grad(loss_fn)(taps)
        updates, opt_state = opt.update(jnp.conj(g), opt_state, taps)
        return optax.apply_updates(taps, updates), opt_state, loss

    rng = np.random.default_rng(0)
    xb = (rng.standard_normal((C, L)) + 1j * rng.standard_normal((C, L))
          ).astype(np.complex64)
    db = np.roll(xb, ntaps // 2, axis=-1)
    tail = np.zeros((C, ntaps - 1), np.complex64)

    # single device
    t1, _, loss1 = jax.jit(train_step)(taps0, opt.init(taps0),
                                       jnp.asarray(tail), jnp.asarray(xb),
                                       jnp.asarray(db))

    # sharded over ('channel','time')
    rep = NamedSharding(mesh, P())
    sh2 = NamedSharding(mesh, P("channel", "time"))
    shc = NamedSharding(mesh, P("channel"))
    f = jax.jit(train_step, in_shardings=(rep, rep, shc, sh2, sh2),
                out_shardings=(rep, rep, rep))
    t2, _, loss2 = f(taps0, opt.init(taps0),
                     jax.device_put(tail, shc), jax.device_put(xb, sh2),
                     jax.device_put(db, sh2))

    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), atol=1e-6)


@needs8
def test_sharded_rx_chain_rejects_unknown_demod():
    mesh = parallel.make_mesh(channel=2, time=4)
    cfg = RxChainConfig(dtype=jnp.complex128, demod="chirp")
    with pytest.raises(ValueError):
        parallel.make_sharded_rx_chain(cfg, mesh)


# --------------------------------------------------------------------------
# the sharded chain calls the SAME fused DDC engine (ops/ddc.py pieces
# path) as models/rx_chain.py
# --------------------------------------------------------------------------

@needs8
def test_sharded_rx_chain_fused_matches_single_chip():
    """Fused-DDC sharded chain == single-chip fused chain (f64, XLA path)."""
    mesh = parallel.make_mesh(channel=2, time=4)
    cfg = RxChainConfig(dtype=jnp.complex128, agc_mode="block", demod="fm",
                        nco_mode="exact", fused_ddc="auto")
    C, L = 4, 2048
    x = np.stack([_tone(L, 0.2 / (2 * np.pi) + 0.001, amp=0.1, seed=c)
                  for c in range(C)])

    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    st = init_s(C)
    out_shard, st2 = apply_s(st, jnp.asarray(x))

    init1, apply1 = make_rx_chain(cfg)
    for c in range(C):
        s1 = init1()
        out_ref, s1b = apply1(s1, jnp.asarray(x[c]))
        np.testing.assert_allclose(np.asarray(out_shard[c]),
                                   np.asarray(out_ref), rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(st2.agc["gain"][c]),
                                   np.asarray(s1b.agc["gain"]), rtol=1e-9)
        # fused chains carry the RAW input tail
        np.testing.assert_allclose(np.asarray(st2.fir_tail[c]),
                                   np.asarray(s1b.fir_tail), atol=1e-12)
    assert int(st2.nco_theta) == int(s1b.nco_theta)

    # streaming continuation across the sharded/carried-state boundary
    x2 = np.stack([_tone(L, 0.2 / (2 * np.pi) + 0.001, amp=0.1, seed=50 + c)
                   for c in range(C)])
    out2_shard, _ = apply_s(st2, jnp.asarray(x2))
    for c in range(C):
        s1 = init1()
        _, s1b = apply1(s1, jnp.asarray(x[c]))
        out2_ref, _ = apply1(s1b, jnp.asarray(x2[c]))
        np.testing.assert_allclose(np.asarray(out2_shard[c]),
                                   np.asarray(out2_ref), rtol=1e-7, atol=1e-9)


@needs8
@pytest.mark.parametrize("demod", ["am", "none", "qpsk"])
def test_sharded_rx_chain_fused_other_demods(demod):
    mesh = parallel.make_mesh(channel=2, time=4)
    cfg = RxChainConfig(dtype=jnp.complex128, agc_mode="block", demod=demod,
                        nco_mode="exact", fused_ddc="auto")
    C, L = 2, 1024
    x = np.stack([_tone(L, 0.035, amp=0.1, seed=c) for c in range(C)])

    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    out_shard, _ = apply_s(init_s(C), jnp.asarray(x))

    init1, apply1 = make_rx_chain(cfg)
    for c in range(C):
        out_ref, _ = apply1(init1(), jnp.asarray(x[c]))
        # qpsk/none materialize the decimated-rate rotation through the
        # factorized fast oscillator, whose per-shard restart regroups the
        # products (~1 ulp class) — hence atol 1e-6 instead of exact
        np.testing.assert_allclose(np.asarray(out_shard[c]),
                                   np.asarray(out_ref), rtol=1e-6, atol=1e-6)


@needs8
def test_sharded_rx_chain_planar_single_stream():
    """Planar (2, L) single-stream mode — the flagship on-chip layout —
    time-sharded over 8 devices vs the single-chip planar fused chain."""
    mesh = parallel.make_mesh(channel=1, time=8)
    cfg = RxChainConfig(dtype=jnp.complex64, agc_mode="block", demod="fm",
                        nco_mode="exact", fused_ddc="on",
                        input_format="planar", fir_precision="x3")
    L = 8 * 2048
    k = np.arange(L)
    sig = 0.1 * np.exp(2j * np.pi * (0.2 / (2 * np.pi) + 0.001) * k)
    x2 = np.stack([sig.real, sig.imag]).astype(np.float32)

    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    st = init_s()
    out_shard, st2 = apply_s(st, jnp.asarray(x2))

    init1, apply1 = make_rx_chain(cfg)
    s1 = init1()
    out_ref, s1b = apply1(s1, jnp.asarray(x2))
    out_shard = np.asarray(out_shard)
    out_ref = np.asarray(out_ref)
    assert out_shard.shape == out_ref.shape
    # f32 + different piece boundaries: gate at >= 60 dB (driver fidelity bar)
    err = out_shard - out_ref
    snr = 10 * np.log10(np.mean(out_ref ** 2) / max(np.mean(err ** 2), 1e-30))
    assert snr > 60.0, f"sharded planar chain SNR {snr:.1f} dB"
    np.testing.assert_allclose(float(st2.agc["gain"]),
                               float(s1b.agc["gain"]), rtol=1e-5)
    assert int(st2.nco_theta) == int(s1b.nco_theta)

    # continuation
    sig2 = 0.1 * np.exp(2j * np.pi * (0.2 / (2 * np.pi) + 0.001) * (k + L))
    x2b = np.stack([sig2.real, sig2.imag]).astype(np.float32)
    out2_shard, _ = apply_s(st2, jnp.asarray(x2b))
    out2_ref, _ = apply1(s1b, jnp.asarray(x2b))
    err2 = np.asarray(out2_shard) - np.asarray(out2_ref)
    snr2 = 10 * np.log10(np.mean(np.asarray(out2_ref) ** 2)
                         / max(np.mean(err2 ** 2), 1e-30))
    assert snr2 > 60.0, f"continuation SNR {snr2:.1f} dB"


@needs8
@pytest.mark.parametrize("n_time,demod", [(2, "fm"), (4, "fm"), (2, "am"),
                                          (4, "qpsk")])
def test_sharded_rx_chain_planar_x3_matches_single_chip(n_time, demod):
    """Time-split planar float32 chain at x3 (the one-wideband-stream
    deployment) == the single-chip chain on the whole block."""
    mesh = parallel.make_mesh(channel=1, time=n_time)
    cfg = RxChainConfig(dtype=jnp.complex64, agc_mode="block", demod=demod,
                        nco_mode="exact", fused_ddc="on",
                        input_format="planar", fir_precision="x3")
    L = 2 * (128 + 8) * 256
    k = np.arange(L)
    sig = 0.1 * np.exp(2j * np.pi * (0.2 / (2 * np.pi) + 0.001) * k)
    x2 = np.stack([sig.real, sig.imag]).astype(np.float32)

    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    out_shard, st2 = apply_s(init_s(), jnp.asarray(x2))

    init1, apply1 = make_rx_chain(cfg)
    out_ref, s1b = apply1(init1(), jnp.asarray(x2))
    err = np.asarray(out_shard) - np.asarray(out_ref)
    snr = 10 * np.log10(np.mean(np.abs(np.asarray(out_ref)) ** 2)
                        / max(np.mean(np.abs(err) ** 2), 1e-30))
    assert snr > 100.0, f"sharded planar chain SNR {snr:.1f} dB"
    np.testing.assert_allclose(float(st2.agc["gain"]),
                               float(s1b.agc["gain"]), rtol=1e-5)


@needs8
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_sharded_rx_chain_qpsk_state_matches_single_chip(fused):
    """Demods that don't consume fm_prev must carry it through UNCHANGED,
    matching the single-chip chain, so checkpoints resume bit-identically
    across deployments (the fused qpsk/none path once overwrote it)."""
    mesh = parallel.make_mesh(channel=2, time=4)
    cfg = RxChainConfig(dtype=jnp.complex128, agc_mode="block", demod="qpsk",
                        nco_mode="exact", fused_ddc=fused)
    C, L = 2, 1024
    x = np.stack([_tone(L, 0.035, amp=0.1, seed=c) for c in range(C)])

    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    st0 = init_s(C)
    _, st_shard = apply_s(st0, jnp.asarray(x))

    init1, apply1 = make_rx_chain(cfg)
    for c in range(C):
        _, st_ref = apply1(init1(), jnp.asarray(x[c]))
        np.testing.assert_array_equal(np.asarray(st_shard.fm_prev[c]),
                                      np.asarray(st_ref.fm_prev))


@needs8
@pytest.mark.parametrize("n_ch,n_time", [(4, 1), (2, 2), (1, 4)])
def test_sharded_channelizer_matches_float64_reference(n_ch, n_time):
    """Tap/channel-split and time-split meshes at M=256 == the float64
    numpy polyphase bank (the four-card smoke's channelizer layout)."""
    from chip_smoke import ref_channelizer
    from solid_dsp_tpu.models.channelizer import channelizer_taps

    M, K = 256, 8
    mesh = parallel.make_mesh(channel=n_ch, time=n_time)
    L = M * 32
    rng = np.random.default_rng(13)
    x = rng.standard_normal(2 * L) + 1j * rng.standard_normal(2 * L)
    init_s, apply_s = parallel.make_sharded_channelizer(
        M, K, mesh=mesh, dtype=jnp.complex64)
    tail = init_s()
    outs = []
    for blk in (x[:L], x[L:]):
        Y, tail = apply_s(tail, jnp.asarray(blk, jnp.complex64))
        outs.append(np.asarray(Y))
    got = np.concatenate(outs)
    ref, _ = ref_channelizer(channelizer_taps(M, K),
                             x.astype(np.complex64), M, K)
    err = np.sum(np.abs(got - ref) ** 2)
    snr = 10 * np.log10(np.sum(np.abs(ref) ** 2) / max(err, 1e-300))
    assert snr > 100.0, f"sharded channelizer vs float64: {snr:.1f} dB"


@needs8
def test_sharded_fused_many_channels_compiles_fast():
    """The vmapped multi-channel fused chain must compile in seconds at
    DP scale (the r4 Python loop over channels was a compile-time bomb:
    one trace per channel).  C = 128 total -> 64 per channel shard."""
    import time

    mesh = parallel.make_mesh(channel=2, time=4)
    cfg = RxChainConfig(dtype=jnp.complex64, agc_mode="block", demod="fm",
                        nco_mode="exact", fused_ddc="auto")
    C, L = 128, 256
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((C, L))
         + 1j * rng.standard_normal((C, L))).astype(np.complex64)
    init_s, apply_s = parallel.make_sharded_rx_chain(cfg, mesh)
    st = init_s(C)
    t0 = time.perf_counter()
    out, st2 = apply_s(st, jnp.asarray(x))
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    assert out.shape == (C, L // 4)
    assert dt < 60.0, f"compile+run took {dt:.1f}s"
