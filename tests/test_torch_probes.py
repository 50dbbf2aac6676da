"""The TPU probes' counterparts (``contextaware_poseformer_tpu_torch/probes``
and K9's one-block launch) against the probes' own references, on the CPU.

The probes under ``experiments/`` hold their kernels against numpy
(``int8_chain_conv.np_chain``/``np_window``, ``int8_primitives.build_ref``)
or against XLA (``layer1_chain_probe.xla_1block``). Importing
``int8_primitives`` runs its ``pallas_call``, and ``int8_chain_conv``'s
references sit beside a TPU kernel, so the numpy references are re-derived
here, line for line; ``xla_1block`` is called from the probe module (its
import runs nothing). The counterparts' plain versions must equal them bit
for bit: every function here is integer, or its floats are exact (the
chain's affine and requant scales are powers of two on small integers, so
the probe's fp32 affine and K10's bf16 one agree). Their CUDA wrappers
refuse CPU tensors; the kernels run on the card (``chip_smoke.py``'s
probes phase and ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contextaware_poseformer_tpu_torch.ops import int8_conv, layer1_chain
from contextaware_poseformer_tpu_torch.probes import int8_chain, window

H, W, C = int8_chain.H, int8_chain.W, int8_chain.C
G = W // 4  # the probes' 4-pixel row groups an image row
RPI = H * G  # rows an image


# ---- experiments/int8_chain_conv.py, re-derived -----------------------------

def np_window(y_f, g):
    """f32 (M,128) post-relu -> windowed (M,192) (``int8_chain_conv.py``)."""
    left = np.roll(y_f, 1, 0)[:, 96:128].copy()
    left[g == 0] = 0
    right = np.roll(y_f, -1, 0)[:, 0:32].copy()
    right[g == G - 1] = 0
    return np.concatenate([left, y_f, right], 1)


def np_chain(xq, wbs, scales, biases, qscales, n_convs):
    """The probe's numpy chain on the int8 windowed input (M, 192)."""
    m = xq.shape[0]
    row = np.arange(m) % RPI
    g = np.arange(m) % G
    x = xq.astype(np.int32)
    accs = []
    for i in range(n_convs):
        wb = wbs[i].astype(np.int32)
        acc = x @ wb[1]
        up = np.roll(x, G, 0) @ wb[0]
        up[row < G] = 0
        dn = np.roll(x, -G, 0) @ wb[2]
        dn[row >= RPI - G] = 0
        acc = acc + up + dn
        accs.append(acc)
        y = np.maximum(acc.astype(np.float32) * scales[i] + biases[i], 0.0)
        xw = np_window(y, g) * qscales[i]
        x = np.clip(np.round(xw), -127, 127).astype(np.int32)
    return x.astype(np.int8), accs


def _bands(k):
    """A 3x3 kernel (dy, dx, Cin, Cout) as the probe's three dy bands
    (3, 192, 128): output pixel o of a 4-pixel group reads window pixel
    j = o + dx + 1 (0..5)."""
    wb = np.zeros((3, 6 * C, 4 * C), np.int8)
    for dy in range(3):
        for o in range(4):
            for dx in (-1, 0, 1):
                j = o + dx + 1
                wb[dy, j * C:(j + 1) * C, o * C:(o + 1) * C] = k[dy, dx + 1]
    return wb


def test_chain_matches_np_chain():
    """K10 chained through its requantizing int8 epilogue (the chain's
    plain version) against the probe's ``np_chain`` on the same image,
    kernels and scales, three 3x3 convs deep: equal. The probe's affine is
    fp32 and multiplies by a requant scale; K10's is bf16 with
    ``127 / amax``; with the scales below (the affine 1/8 and ``127 /
    amax`` 1 at amax 127) and accumulators below 256 both are exact, so
    they agree bit for bit (asserted)."""
    rng = np.random.RandomState(0)
    n, nb = 3, 2
    img = rng.randint(-3, 4, (nb, H, W, C)).astype(np.int8)
    kernels = [(rng.randint(-1, 2, (3, 3, C, C))
                * (rng.rand(3, 3, C, C) < 0.4)).astype(np.int8)
               for _ in range(n)]
    biases = [(rng.randint(-4, 5, C) / 8).astype(np.float32)
              for _ in range(n)]
    g = np.arange(nb * RPI) % G
    xw = np_window(img.reshape(nb * RPI, 4 * C).astype(np.float32), g)
    want, accs = np_chain(
        xw.astype(np.int8), [_bands(k) for k in kernels], [2.0 ** -3] * n,
        [np.tile(b, 4) for b in biases], [1.0] * n, n)
    assert max(np.abs(a).max() for a in accs) + 4 < 256
    convs = [(torch.from_numpy(k.transpose(3, 0, 1, 2).reshape(C, 9 * C)
                               .copy()),
              torch.ones(C), torch.full((C,), 2.0 ** -3),
              torch.from_numpy(b)) for k, b in zip(kernels, biases)]
    amaxes = [torch.tensor(127.0)] * (n + 1)
    ours = int8_chain.chain(torch.from_numpy(img), convs, amaxes)
    assert ours.dtype == torch.int8 and ours.shape == (nb, H, W, C)
    np.testing.assert_array_equal(
        ours.numpy(), want[:, C:5 * C].reshape(nb, H, W, C))
    assert 0.2 < (ours != 0).float().mean().item() < 0.8


# ---- experiments/int8_chain_micro.py: K10's pieces ---------------------------

def test_micro_pieces_plain_versions():
    """The pieces' plain versions are K10's arithmetic cut apart: the
    accumulation is the probe's banded ``matmul3`` and, over a
    pre-windowed 576-lane input, its ``matmul1``; the epilogue and the
    quantize pass compose to K10's plain version; the bf16 main loop
    sums exact bf16 products."""
    rng = np.random.RandomState(1)
    img = rng.randint(-127, 128, (1, H, W, C)).astype(np.int8)
    k = rng.randint(-8, 9, (3, 3, C, C)).astype(np.int8)
    kq = torch.from_numpy(k.transpose(3, 0, 1, 2).reshape(C, 9 * C).copy())
    acc = int8_chain.accum_reference(torch.from_numpy(img), kq)
    g = np.arange(RPI) % G
    x = np_window(img.reshape(RPI, 4 * C).astype(np.float32), g).astype(
        np.int32)
    wb = _bands(k).astype(np.int32)
    row = np.arange(RPI)
    want = x @ wb[1]
    want += np.where((row >= G)[:, None], np.roll(x, G, 0) @ wb[0], 0)
    want += np.where((row < RPI - G)[:, None], np.roll(x, -G, 0) @ wb[2], 0)
    np.testing.assert_array_equal(acc.numpy().reshape(RPI, 4 * C), want)
    # matmul1: one (M, 576) x (576, 128) GEMM as a 1x1 conv
    x3 = np.concatenate([np.roll(x, G, 0), x, np.roll(x, -G, 0)], 1)
    w1 = np.concatenate([wb[0], wb[1], wb[2]], 0)
    acc1 = int8_chain.accum_reference(
        torch.from_numpy(x3.astype(np.int8).reshape(1, H, G, 576)),
        torch.from_numpy(w1.T.astype(np.int8).copy()))
    np.testing.assert_array_equal(acc1.numpy().reshape(RPI, 128), x3 @ w1)
    # requant after the accumulation is K10's plain version
    ws, sc, bi = (torch.from_numpy(v.astype(np.float32)) for v in (
        rng.rand(C) * 0.01 + 1e-3, rng.rand(C) + 0.5, rng.randn(C) * 0.1))
    a_in, a_out = torch.tensor(9.0), torch.tensor(20.0)
    np.testing.assert_array_equal(
        int8_chain.requant_reference(acc, ws, sc, bi, a_in, a_out).numpy(),
        int8_conv.int8_conv_reference(torch.from_numpy(img), kq, ws, sc, bi,
                                      a_in, 1, True,
                                      out_amax=a_out).numpy())
    # the quantize pass, then the accumulation, is the calibrated route's
    xb = torch.from_numpy(rng.randn(1, H, W, C).astype(np.float32) * 3).to(
        torch.bfloat16)
    xq = int8_chain.quantize_reference(xb, torch.tensor(5.0))
    step = np.float32(5.0) * np.float32(1 / np.float32(127))
    np.testing.assert_array_equal(
        xq.numpy(), np.clip(np.round(xb.float().numpy() / step), -127, 127))
    assert torch.equal(
        int8_conv.int8_conv_reference(xb, kq, ws, sc, bi, torch.tensor(5.0),
                                      1, False),
        int8_conv.int8_conv_reference(xq, kq, ws, sc, bi, torch.tensor(5.0),
                                      1, False))
    # the bf16 main loop: exact products, sums within fp32 rounding
    wbf = kq.to(torch.bfloat16) / 16
    got = int8_chain.bf16_conv_reference(xb, wbf).numpy()
    assert got.dtype == np.float32 and got.shape == (1, H, W, C)
    ref = torch.nn.functional.conv2d(
        xb.double().permute(0, 3, 1, 2),
        wbf.double().reshape(C, 3, 3, C).permute(0, 3, 1, 2),
        padding=1).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ---- experiments/int8_primitives.py, re-derived -----------------------------

def test_window_matmul_matches_build_ref():
    """The window-shift probe's function, ``xwin @ w + roll(xwin, -12) @
    w``, against its ``build_ref`` (same seed and draws): equal."""
    m, k, n = window.M, window.K, window.N
    rng = np.random.RandomState(0)
    xf = rng.randn(m, 128).astype(np.float32) * 2
    w = rng.randint(-20, 21, (k, n)).astype(np.int8)
    amax = 4.0
    q = lambda t: np.clip(np.round(t * (127.0 / amax)), -127, 127)
    grp = np.arange(m) % 12
    left = np.roll(xf, 1, 0)[:, 96:128].copy()
    left[grp == 0] = 0
    right = np.roll(xf, -1, 0)[:, 0:32].copy()
    right[grp == 11] = 0
    xwin = q(np.concatenate([left, xf, right], axis=1)).astype(np.int32)
    wn = w.astype(np.int32)
    want = xwin @ wn + np.roll(xwin, -12, 0) @ wn
    a = torch.tensor(amax)
    np.testing.assert_array_equal(
        window.window(torch.from_numpy(xf), a).numpy(), xwin)
    ours = window.window_matmul_reference(torch.from_numpy(xf),
                                          torch.from_numpy(w), a)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), want)


# ---- experiments/layer1_chain_probe.py: one block ----------------------------

def test_one_block_matches_the_probes_xla_1block():
    """K9's plain version on one bottleneck block (bf16 stem output in,
    int8 out) against the probe's ``xla_1block`` on the same weights and
    folded scales: equal, the statistic the probe's ``stats`` prints."""
    from experiments.layer1_chain_probe import xla_1block

    rng = np.random.RandomState(2)
    g = torch.Generator().manual_seed(2)

    def pieces(o, kk):
        return (torch.randint(-127, 128, (o, kk), generator=g,
                              dtype=torch.int8),
                torch.rand(o, generator=g) * 0.02 + 1e-3,
                torch.rand(o, generator=g) + 0.5,
                torch.randn(o, generator=g) * 0.1)

    blk = {"conv1": pieces(64, 64), "conv2": pieces(64, 576),
           "conv3": pieces(256, 64), "downsample": pieces(256, 64),
           "t1": torch.tensor(60.0), "t2": torch.tensor(80.0),
           "out": torch.tensor(45.0)}
    a_in = torch.tensor(6.0)
    x = torch.from_numpy(rng.randn(2, 8, 12, 64).astype(np.float32) * 2).to(
        torch.bfloat16)
    ours = layer1_chain.layer1_chain_reference(x, a_in, [blk])
    chain = layer1_chain.layer1_int8_chain(x, a_in, [blk])
    assert torch.equal(ours, chain)

    def fold(conv, amax):  # K10's bf16 affine of ``conv`` after ``amax``
        kq, ws, sc, bi = blk[conv]
        step = int8_conv.dequant_step(amax, clamp=True)
        eff = (sc * ws * step).to(torch.bfloat16)
        return (jnp.asarray(eff.float().numpy(), jnp.bfloat16)[None, None],
                jnp.asarray(bi.numpy(), jnp.bfloat16)[None, None])

    def r127(a):  # 127 / amax in fp32, as K10 requantizes
        return float(torch.div(torch.tensor(127.0), a))

    s1, b1 = fold("conv1", a_in)
    s2, b2 = fold("conv2", blk["t1"])
    s3, b3 = fold("conv3", blk["t2"])
    sds, bds = fold("downsample", a_in)
    sca = np.zeros(17, np.float32)
    sca[0], sca[1], sca[5], sca[9] = (r127(a_in), r127(blk["t1"]),
                                      r127(blk["t2"]), r127(blk["out"]))
    pack = {
        "w1_0": jnp.asarray(blk["conv1"][0].numpy().T),
        "w2": jnp.asarray(blk["conv2"][0].numpy().reshape(64, 3, 192)
                          .transpose(1, 2, 0))[None],
        "w3": jnp.asarray(blk["conv3"][0].numpy().T)[None],
        "wds": jnp.asarray(blk["downsample"][0].numpy().T),
        "s1": s1, "b1": b1, "s2": s2, "b2": b2, "s3": s3, "b3": b3,
        "sds": sds[0], "bds": bds[0], "sca": jnp.asarray(sca),
    }
    theirs = np.asarray(xla_1block(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), pack))
    d = np.abs(ours.numpy().astype(np.int32) - theirs.astype(np.int32))
    assert (d == 0).mean() == 1.0, (d == 0).mean()
    assert 0 < (ours.abs() == 127).float().mean().item() < 0.5


def test_probe_wrappers_refuse_cpu_tensors():
    """No wrapper falls back to its plain version: each raises on CPU
    tensors before it would build or launch anything."""
    x = torch.zeros(1, 8, 8, 32, dtype=torch.int8)
    kq = torch.zeros(32, 288, dtype=torch.int8)
    xb = torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16)
    vec = torch.ones(32)
    calls = [
        lambda: int8_chain.accum(x, kq),
        lambda: int8_chain.accum(x, kq, mask=False),
        lambda: int8_chain.bf16_conv(xb, kq.to(torch.bfloat16)),
        lambda: int8_chain.requant(torch.zeros(64, 32, dtype=torch.int32),
                                   vec, vec, vec, vec[0], vec[0]),
        lambda: int8_chain.quantize(xb, vec[0]),
        lambda: window.window_matmul(torch.zeros(768, 128),
                                     torch.zeros(192, 128, dtype=torch.int8),
                                     vec[0]),
        lambda: layer1_chain.layer1_block_kernel(
            torch.zeros(1, 8, 48, 64, dtype=torch.bfloat16), vec[0], {
                "conv1": (torch.zeros(64, 64, dtype=torch.int8), *[
                    torch.ones(64)] * 3),
                "conv2": (torch.zeros(64, 576, dtype=torch.int8), *[
                    torch.ones(64)] * 3),
                "conv3": (torch.zeros(256, 64, dtype=torch.int8), *[
                    torch.ones(256)] * 3),
                "downsample": (torch.zeros(256, 64, dtype=torch.int8), *[
                    torch.ones(256)] * 3),
                "t1": vec[0], "t2": vec[0], "out": vec[0]}, floor=True),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(v == 0 for v in (*int8_chain.launches.values(),
                                *window.launches.values()))
    assert layer1_chain.launches_floor == 0
