"""The launch plans of K10s (the fold stem, ``csrc/stem_conv.cu``) and K10u
(the s8 top-down hop, ``csrc/topdown.cu``), held on the CPU against what
their kernels read: ``int8_conv.stem_plan`` and ``int8_conv.topdown_plan``
are the numbers each kernel takes its geometry from.

- K10s: the bands of every segment cover each output row once and the
  segments each output column once; a Python mirror of the kernel's ring
  (its rows staged ``STEM_AHEAD`` ahead into ``(b * period + iy) % 16``)
  holds every kernel row a row reads, and no staging overwrites a row or a
  bias-map row that a row still computing (or the one before it, whose
  warps may lag behind the barrier) reads; a warp's kept A fragments hold
  every kernel row of its window when it reads them; each 7x7 tap's bytes
  lie in the staged row, padding pieces whole; shared memory fits a block.
- K10u: strips, column tiles and channel slices cover each output element
  once; every interpolation tap of a strip or tile lies in the source rows
  and columns it stages; shared memory fits; a numpy emulation of the
  kernel's two passes, from the staged row-pass values, equals
  ``topdown_reference`` bit for bit in bf16 and fp32.
"""

import numpy as np
import pytest
import torch

from contextaware_poseformer_tpu_torch.ops import _build, int8_conv

SMEM_LIMIT = 232448  # the shared memory one H100 block may take

# ---- K10s -----------------------------------------------------------------

STEM_SERVED = [(64, 256, 192), (1, 256, 192)]
STEM_EDGES = [(3, 37, 64), (2, 16, 32), (2, 1, 64), (1, 1, 32)]
STEM_SWEEP = [(b, h, w) for b in (1, 2, 5) for h in (1, 2, 3, 4, 5, 7, 8, 9)
              for w in (32, 96, 160, 2048, 2080)]


def _stem_windows(h, b, oy):
    return [(b, iy) for iy in range(2 * oy - 3, 2 * oy + 4) if 0 <= iy < h]


def _stem_band(p, h, r0, r1):
    """Run the kernel's loop over rows [r0, r1) of a band: the staging of
    row s (the rows its window adds to row s - 1's, all of them for the
    band's first row or an image's first, and its map row) STEM_AHEAD rows
    ahead, each before the barrier of the row that computes. Returns the
    rows computed in order."""
    ho = (h + 1) // 2
    ahead, mslots = p.ahead, p.map_slots
    ring = {}  # slot -> (b, iy, staged for row s)
    maps = {}  # map slot -> (oy, staged for row s)
    pos = {}  # row s -> (b, oy)
    nxt = [r0 // ho, r0 % ho]

    def live_reads(lo, hi):
        """The ring slots and map slots rows lo..hi read."""
        ring_slots, map_slots = set(), set()
        for s in range(max(lo, r0), min(hi, r1 - 1) + 1):
            if s in pos:
                b, oy = pos[s]
                ring_slots |= {(b * p.period + iy) % int8_conv.STEM_SLOTS
                               for _, iy in _stem_windows(h, b, oy)}
                map_slots.add(s % mslots)
        return ring_slots, map_slots

    def stage(s, r):
        if s >= r1:
            return
        b, oy = nxt
        pos[s] = (b, oy)
        lo, hi = ((2 * oy - 3, 2 * oy + 3) if s == r0 or oy == 0
                  else (2 * oy + 2, 2 * oy + 3))
        # rows r - 1 .. s - 1 may still be read while these land
        busy_ring, busy_map = live_reads(r - 1, s - 1)
        for iy in range(max(lo, 0), min(hi, h - 1) + 1):
            slot = (b * p.period + iy) % int8_conv.STEM_SLOTS
            assert slot not in busy_ring, (s, b, iy, slot)
            ring[slot] = (b, iy, s)
        assert s % mslots not in busy_map, s
        maps[s % mslots] = (oy, s)
        nxt[1] += 1
        if nxt[1] == ho:
            nxt[:] = [b + 1, 0]

    for k in range(ahead):
        stage(r0 + k, r0)
    done = []
    frags = {}  # a warp's kept A fragments (bf16): slot -> (b, iy)
    for r in range(r0, r1):
        stage(r + ahead, r)
        b, oy = pos[r]
        for _, iy in _stem_windows(h, b, oy):
            slot = (b * p.period + iy) % int8_conv.STEM_SLOTS
            got = ring[slot]
            assert got[:2] == (b, iy) and got[2] <= r, (r, iy, got)
        assert maps[r % mslots] == (oy, r)
        # the rows the window adds (all of it at the band's or an image's
        # first row) are built from the ring, then the window is read
        first = 2 * oy - 3 if r == r0 or oy == 0 else 2 * oy + 2
        for iy in range(max(first, 0), min(2 * oy + 3, h - 1) + 1):
            frags[(b * p.period + iy) % int8_conv.STEM_FRAG_SLOTS] = (b, iy)
        for key in _stem_windows(h, b, oy):
            slot = (b * p.period + key[1]) % int8_conv.STEM_FRAG_SLOTS
            assert frags.get(slot) == key, (r, key, frags.get(slot))
        done.append((b, oy))
    return done


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", STEM_SERVED + STEM_EDGES + STEM_SWEEP)
def test_stem_plan_computes_every_row_once_from_staged_rows(shape, itemsize):
    """Every (output row, column) of a K10s launch is computed exactly once,
    each from kernel rows staged for it and not overwritten before it
    reads them; the plan fits a block's shared memory."""
    batch, h, w = shape
    p = int8_conv.stem_plan(batch, h, w, itemsize)
    ho, wo = (h + 1) // 2, w // 2
    assert p.smem == int8_conv.stem_smem_bytes(p.seg, itemsize)
    assert p.smem <= SMEM_LIMIT and p.threads <= 256
    assert p.seg % 16 == 0 and p.segs == -(-wo // p.seg)
    assert p.threads // 32 >= p.seg // 16 and p.grid == p.segs * p.bands
    rows = batch * ho
    done = []
    for band in range(p.bands):
        r0, r1 = rows * band // p.bands, rows * (band + 1) // p.bands
        assert r1 > r0  # no band is empty
        done += _stem_band(p, h, r0, r1)
    assert done == [(b, oy) for b in range(batch) for oy in range(ho)]
    cols = [c for s in range(p.segs)
            for c in range(s * p.seg, min((s + 1) * p.seg, wo))]
    assert cols == list(range(wo))


@pytest.mark.parametrize("shape", STEM_SERVED + STEM_EDGES + [(1, 8, 2048)])
def test_stem_taps_lie_in_the_staged_row(shape):
    """A segment's staged row holds every byte its pixels' 7 taps x 3
    channels read (6 ox - 9 .. 6 ox + 11), the 4-byte windows the A
    fragments assemble from two words (k-steps of 32 bytes) stay inside
    it, and every 16-byte piece is wholly inside the frame's row (a copy)
    or wholly outside it (zero padding)."""
    batch, h, w = shape
    p = int8_conv.stem_plan(batch, h, w)
    lead = int8_conv.STEM_LEAD
    for s in range(p.segs):
        c0 = s * p.seg
        x0 = 6 * c0 - lead  # the frame byte of staged byte 0
        assert x0 % 16 == 0 and (3 * w) % 16 == 0
        npx = min(p.seg, w // 2 - c0)
        for ox in range(c0, c0 + npx):
            first = lead - 9 + 6 * (ox - c0)
            # the frame bytes a pixel's taps read map to their staged bytes
            for k in range(21):
                xb = 6 * ox - 9 + k
                assert x0 + first + k == xb and 0 <= first + k < p.pitch
            # a k-step's 32 bytes, as 4-byte windows at first + 4 k (k < 8),
            # each assembled from its aligned word and the next
            assert first >= 0 and (first + 28) // 4 + 1 < p.pitch // 4
        for piece in range(p.pitch // 16):
            xb = x0 + 16 * piece
            assert (0 <= xb and xb + 16 <= 3 * w) or \
                xb + 16 <= 0 or xb >= 3 * w


# ---- K10u -----------------------------------------------------------------

HOPS = [(8, 6, 256), (16, 12, 256), (32, 24, 256)]
TOPDOWN_EDGES = [(1, 1, 8), (5, 3, 24), (2, 7, 16)]
TOPDOWN_SWEEP = [(h, w, c) for h in (1, 2, 3, 7, 64) for w in (1, 2, 5, 48)
                 for c in (8, 40, 264)] + [(2, 3000, 264), (3, 1500, 520)]


def _topdown_blocks(p, h, w, c):
    """Each block's (oy0, rows, ox0, cols, c0, channels, lo, source rows,
    jlo, source columns), as the kernel finds them from blockIdx and the
    tap tables."""
    ri, _ = int8_conv.interp_table(2 * h, h)
    ci, _ = int8_conv.interp_table(2 * w, w)
    for strip in range(p.strips):
        oy0 = strip * p.rows
        nr = min(p.rows, 2 * h - oy0)
        lo = int(ri[oy0, 0])
        for tile in range(p.tiles):
            ox0 = tile * p.cols
            nc = min(p.cols, 2 * w - ox0)
            jlo = int(ci[ox0, 0])
            for sl in range(p.slices):
                c0 = sl * p.chans
                yield (oy0, nr, ox0, nc, c0, min(p.chans, c - c0), lo,
                       int(ri[oy0 + nr - 1, 1]) - lo + 1, jlo,
                       int(ci[ox0 + nc - 1, 1]) - jlo + 1)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hwc", HOPS + TOPDOWN_EDGES + TOPDOWN_SWEEP)
def test_topdown_plan_covers_each_output_once_from_staged_taps(hwc,
                                                               itemsize):
    """K10u's blocks cover every output row, column and channel once;
    every row tap of a strip and column tap of a tile lies in the source
    rows and columns it stages; the plan fits a block."""
    h, w, c = hwc
    p = int8_conv.topdown_plan(h, w, c, itemsize)
    assert p.smem == int8_conv.topdown_smem_bytes(
        p.rows, p.cols, p.chans, p.src_rows, p.src_cols, itemsize)
    assert p.smem <= SMEM_LIMIT and p.smem <= int8_conv.TOPDOWN_SMEM
    assert p.chans % 8 == 0 and p.chans <= int8_conv.TOPDOWN_MAX_CHANNELS
    gx, gy = p.block
    assert gx * gy <= int8_conv.TOPDOWN_THREADS and gx == p.chans // 8
    ri, _ = int8_conv.interp_table(2 * h, h)
    ci, _ = int8_conv.interp_table(2 * w, w)
    rows, cols, chans = [], [], []
    for (oy0, nr, ox0, nc, c0, cc, lo, ns, jlo, nj) in _topdown_blocks(
            p, h, w, c):
        assert nr >= 1 and nc >= 1 and cc >= 8 and cc % 8 == 0
        assert ns <= p.src_rows and nj <= p.src_cols
        assert lo <= ri[oy0:oy0 + nr].min() and \
            ri[oy0:oy0 + nr].max() < lo + ns
        assert jlo <= ci[ox0:ox0 + nc].min() and \
            ci[ox0:ox0 + nc].max() < jlo + nj
        assert lo + ns <= h and jlo + nj <= w
        if ox0 == 0 and c0 == 0:
            rows += range(oy0, oy0 + nr)
        if oy0 == 0 and c0 == 0:
            cols += range(ox0, ox0 + nc)
        if oy0 == 0 and ox0 == 0:
            chans += range(c0, c0 + cc)
    assert rows == list(range(2 * h)) and cols == list(range(2 * w))
    assert chans == list(range(c))
    assert p.grid(3) == 3 * p.strips * p.tiles * p.slices


def _round(x, dtype):
    """fp32 numpy values rounded to ``dtype`` (bf16: round to nearest even,
    as the kernel's conversions), back in fp32."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _topdown_emulation(q, ua, lat, dtype):
    """K10u block by block as the kernel computes it: the strip's source
    rows and the tile's source columns staged, the row pass once per
    (output row, source column, channel) into E, then the column pass, the
    dequantize and the lateral add per output pixel; each product and sum
    in fp32 (numpy float32), each pass rounded once to E."""
    b, h, w, c = q.shape
    p = int8_conv.topdown_plan(h, w, c, torch.empty((), dtype=dtype)
                               .element_size())
    ri, rw = int8_conv.interp_table(2 * h, h, dtype)
    ci, cw = int8_conv.interp_table(2 * w, w, dtype)
    f32 = np.float32
    s = _round(np.array([max(f32(ua), f32(1e-12)) * f32(int8_conv.RECIP_127)],
                        f32), dtype)[0]
    out = np.zeros(lat.shape, f32)
    for (oy0, nr, ox0, nc, c0, cc, lo, ns, jlo, nj) in _topdown_blocks(
            p, h, w, c):
        staged = q[:, lo:lo + ns, jlo:jlo + nj, c0:c0 + cc].astype(f32)
        r = np.empty((b, nr, nj, cc), f32)
        for y in range(nr):
            i0, i1 = ri[oy0 + y] - lo
            r[:, y] = _round(rw[oy0 + y, 0] * staged[:, i0]
                             + rw[oy0 + y, 1] * staged[:, i1], dtype)
        for x in range(nc):
            j0, j1 = ci[ox0 + x] - jlo
            u = _round(cw[ox0 + x, 0] * r[:, :, j0]
                       + cw[ox0 + x, 1] * r[:, :, j1], dtype)
            up = _round(u * s, dtype)
            out[:, oy0:oy0 + nr, ox0 + x, c0:c0 + cc] = _round(
                lat[:, oy0:oy0 + nr, ox0 + x, c0:c0 + cc] + up, dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hwc", [(8, 6, 16), (16, 12, 16), (32, 24, 8),
                                 (1, 1, 8), (1, 5, 8), (5, 1, 24)])
def test_topdown_two_pass_order_equals_the_plain_version(hwc, dtype):
    """The kernel's order (rows first from the staged s8 rows, each row-pass
    value once, then columns, E(u * s), E(lat + up)) at the three hops (a
    small batch and C) and at h = 1 and w = 1 equals ``topdown_reference``
    bit for bit."""
    h, w, c = hwc
    rng = np.random.default_rng(h * 31 + w)
    q = rng.integers(-127, 128, (2, h, w, c), dtype=np.int8)
    lat = _round(rng.standard_normal((2, 2 * h, 2 * w, c)).astype(np.float32),
                 dtype)
    ua = np.float32(6.3)
    ref = int8_conv.topdown_reference(
        torch.from_numpy(q), torch.tensor(ua), torch.from_numpy(lat).to(dtype),
        dtype).float().numpy()
    np.testing.assert_array_equal(_topdown_emulation(q, ua, lat, dtype), ref)


def test_plans_match_the_kernels_limits():
    """The plans' constants mirror the kernels': K10s's ring of 16 slots,
    its rows staged 2 ahead in bf16 and 1 in fp32 (two blocks an SM in
    both), its whole warpgroups; K10u's threads; both within the opt-in
    shared memory."""
    assert int8_conv.STEM_SLOTS == 16
    for itemsize, ahead in ((2, 2), (4, 1)):
        p = int8_conv.stem_plan(64, 256, 192, itemsize)
        assert p.ahead == ahead and p.map_slots == ahead + 2
        assert p.threads == 256 and p.bands == 2 * int8_conv.SMS
        assert 2 * (p.smem + 1024) <= int8_conv.SM_SMEM
    assert int8_conv.TOPDOWN_THREADS == 256
    assert _build.SMEM_LIMIT == SMEM_LIMIT
