"""The CUDA kernels of `parmmg_tpu_torch` against their plain PyTorch
versions on the card (no JAX needed). They skip where there is no GPU;
on one, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version round every operation the same way (the kernels
are compiled with -fmad=false and follow the plain versions' expression
order), so volumes, the collapse gate's -inf positions and the split
booleans must be equal; qualities differ only through the library `pow`,
within `_rtol` of tests/test_m18_kernels.py (5e-6 at f32, 5e-11 at f64).
The fixture is test_m18's (P=1500, N=4000, seed 7), and for the tile loop
of quality_vol and collapse_cavity also streams at its edges (empty, one
row, a tile and one row either side, several tiles a CTA with a ragged
end, views off 16-byte alignment); interp_bary's is its interp case (the
unit cube n=4's tets, 1024 seeded points), also stacked over three
shards. split_midpoint and interp_bary, one row a thread, are also run
at the edges of their grid (no rows, one row, a CTA and one row either
side of it, shards whose rows do not fill their last CTA, index streams
off 16-byte alignment), where both must equal their plain versions bit
for bit.
"""

import numpy as np
import pytest
import torch

from parmmg_tpu_torch import kernels
from parmmg_tpu_torch.ops.common import POS_VOL_FRAC
from parmmg_tpu_torch.utils import gen

RTOL = {torch.float32: 5e-6, torch.float64: 5e-11}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _fixture(dev, dt):
    rng = np.random.default_rng(7)
    P, N = 1500, 4000
    vert = torch.tensor(rng.normal(size=(P, 3)), dtype=dt, device=dev)
    met = torch.tensor(rng.uniform(0.05, 0.4, size=(P, 1)), dtype=dt,
                       device=dev)
    met6 = torch.tensor(rng.uniform(0.5, 2.0, size=(P, 6)), dtype=dt,
                        device=dev)
    tet = torch.tensor(rng.integers(0, P, size=(N, 4)), dtype=torch.int32,
                       device=dev)
    rng2 = np.random.default_rng(11)
    newp = torch.tensor(rng2.normal(size=(N, 3)), dtype=dt, device=dev)
    li = torch.tensor(rng2.integers(0, 4, N), dtype=torch.int32, device=dev)
    lj = torch.tensor(rng2.integers(0, 4, N), dtype=torch.int32, device=dev)
    return vert, met, met6, tet, newp, li, lj


@pytest.mark.cuda
def test_kernels_on_the_card():
    """Each kernel against its plain version at f32 and f64, C = 1 and 6;
    then the wrappers' refusals of what the kernels do not take; then
    interp_bary, stacked and not."""
    dev = _cuda()
    for dt in (torch.float32, torch.float64):
        vert, met, met6, tet, newp, li, lj = _fixture(dev, dt)
        kernels.reset_launches()
        for m in (met, met6):
            q, vol = kernels.quality_vol(vert, m, tet)
            q0, vol0 = kernels.quality_vol_plain(vert, m, tet)
            assert torch.equal(vol, vol0)
            torch.testing.assert_close(q, q0, rtol=RTOL[dt], atol=0)
            floor = POS_VOL_FRAC * vol0.abs().roll(1)
            g = kernels.collapse_cavity(vert, m, tet, floor)
            g0 = kernels.collapse_cavity_plain(vert, m, tet, floor)
            assert torch.equal(torch.isinf(g), torch.isinf(g0))
            fin = torch.isfinite(g0)
            assert 0 < int(fin.sum()) < tet.shape[0]
            torch.testing.assert_close(g[fin], g0[fin], rtol=RTOL[dt],
                                       atol=0)
        ok = kernels.split_midpoint(vert, tet, newp, li, lj)
        ok0 = kernels.split_midpoint_plain(vert, tet, newp, li, lj)
        assert torch.equal(ok, ok0) and 0 < int(ok0.sum()) < tet.shape[0]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {"quality_vol": 2, "collapse_cavity": 2,
                                    "split_midpoint": 1, "interp_bary": 0}
        assert kernels.SHAPES["quality_vol"] == (4000, 1500)

    vert, met, _, tet, *_ = _fixture(dev, torch.float32)
    with pytest.raises(TypeError):
        kernels.quality_vol(vert, met, tet.long())
    with pytest.raises(TypeError):
        kernels.quality_vol(vert, met.double(), tet)
    with pytest.raises(ValueError):
        kernels.quality_vol(vert, met[:, :1].expand(-1, 2), tet)
    with pytest.raises(ValueError):
        kernels.quality_vol(vert, met, tet.t().contiguous().t())
    _check_tile_edges(dev)
    _check_interp_bary(dev)
    _check_row_edges(dev)


def _offset_view(t):
    """`t` copied into a larger buffer at an offset of one element, so
    that the view's base is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and (v.numel() == 0 or v.data_ptr() % 16 != 0)
    return v


def _check_tile_edges(dev):
    """quality_vol and collapse_cavity at the edges of their tile loop
    (csrc/tile_loop.cuh), f32 and f64, C = 1 and 6: no rows, one row, one
    tile and one row either side of it, and a stream that gives every CTA
    several tiles and ends in a ragged one; each with index rows and
    floors read through the shared-memory ring where the loop takes it
    and, from views whose base is off 16-byte alignment, with ordinary
    loads. One launch per call with rows, none without."""
    rng = np.random.default_rng(17)
    tile = kernels.build.tile_rows()
    # an SM of Hopper holds at most 32 CTAs, so every CTA of the grid
    # walks at least three tiles, the last one ragged
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    many = 3 * sms * 32 * tile + 7
    for dt in (torch.float32, torch.float64):
        vert, met, met6, *_ = _fixture(dev, dt)
        P = vert.shape[0]
        for m in (met, met6):
            for n in (0, 1, tile - 1, tile, tile + 1, many):
                tet = torch.tensor(rng.integers(0, P, size=(n, 4)),
                                   dtype=torch.int32, device=dev)
                _, vol0 = kernels.quality_vol_plain(vert, m, tet)
                floor = POS_VOL_FRAC * vol0.abs().roll(1)
                for t, f in ((tet, floor), (_offset_view(tet),
                                            _offset_view(floor))):
                    before = dict(kernels.LAUNCHES)
                    q, vol = kernels.quality_vol(vert, m, t)
                    g = kernels.collapse_cavity(vert, m, t, f)
                    q0, vol0 = kernels.quality_vol_plain(vert, m, t)
                    g0 = kernels.collapse_cavity_plain(vert, m, t, f)
                    torch.cuda.synchronize()
                    for k in ("quality_vol", "collapse_cavity"):
                        assert kernels.LAUNCHES[k] == before[k] + (n > 0)
                    assert q.shape == vol.shape == g.shape == (n,)
                    assert torch.equal(vol, vol0)
                    torch.testing.assert_close(q, q0, rtol=RTOL[dt], atol=0)
                    assert torch.equal(torch.isinf(g), torch.isinf(g0))
                    fin = torch.isfinite(g0)
                    torch.testing.assert_close(g[fin], g0[fin],
                                               rtol=RTOL[dt], atol=0)


def _check_interp_bary(dev):
    """interp_bary against its plain version at f32 and f64 (C = 1), one
    launch for a stacked [D,Q] call whose rows each read their own
    shard's table; anisotropic sizes take the plain version without a
    launch."""
    for dt in (torch.float32, torch.float64):
        mesh = gen.unit_cube_mesh(4, dtype=dt, device=dev)
        rng = np.random.default_rng(13)
        Q, D = 1024, 3
        P = mesh.pcap
        vids = mesh.tet[torch.as_tensor(rng.integers(0, int(mesh.ntet), Q),
                                        device=dev)].contiguous()
        pts = torch.tensor(rng.uniform(0.0, 1.0, (D, Q, 3)), dtype=dt,
                           device=dev)
        # each shard's table: the cube moved and its sizes drawn anew
        vert = torch.stack([mesh.vert + 0.1 * s for s in range(D)])
        met = torch.tensor(rng.uniform(0.05, 0.4, (D, P, 1)), dtype=dt,
                           device=dev)
        vids3 = vids[None].expand(D, Q, 4).contiguous()
        kernels.reset_launches()
        b, m = kernels.interp_bary(vert, met, vids3, pts)
        assert kernels.LAUNCHES["interp_bary"] == 1
        assert kernels.SHAPES["interp_bary"] == (Q, P, D)
        b0, m0 = kernels.interp_bary_plain(vert, met, vids3, pts)
        torch.testing.assert_close(b, b0, rtol=0, atol=RTOL[dt])
        torch.testing.assert_close(m, m0, rtol=RTOL[dt], atol=0)
        assert float(b.min()) >= 0.0 and int((b == 0).any(-1).sum()) > 0
        for s in range(D):
            b1, m1 = kernels.interp_bary(vert[s], met[s], vids, pts[s])
            assert torch.equal(b1, b[s]) and torch.equal(m1, m[s])
        assert kernels.LAUNCHES["interp_bary"] == 1 + D
        met6 = torch.tensor(rng.uniform(0.5, 2.0, (P, 6)), dtype=dt,
                            device=dev)
        b6, m6 = kernels.interp_bary(vert[0], met6, vids, pts[0])
        assert m6.shape == (Q, 6) and torch.equal(b6, b[0])
        assert kernels.LAUNCHES["interp_bary"] == 1 + D
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        kernels.interp_bary(vert[0], met[0], vids.long(), pts[0])
    with pytest.raises(ValueError):
        kernels.interp_bary(vert, met, vids, pts[0])


def _check_row_edges(dev):
    """split_midpoint and interp_bary at the edges of their grid
    (csrc/row_grid.cuh), f32 and f64: no rows, one row, a CTA and one
    row either side of it, and several CTAs with a ragged last one; each
    also with its index stream (and the other row streams) in views off
    16-byte alignment; interp_bary also stacked at D=1 and D=3 with Q not
    a multiple of the CTA. Outputs
    equal to the plain versions' bit for bit, one launch per call with
    rows, none without."""
    rng = np.random.default_rng(19)
    T = kernels.build.row_threads()
    sizes = (0, 1, T - 1, T, T + 1, 3 * T + 5)
    for dt in (torch.float32, torch.float64):
        vert, _, _, tet, newp, li, lj = _fixture(dev, dt)
        for n in sizes:
            rows = (tet[:n], newp[:n], li[:n], lj[:n])
            for a in (rows, tuple(_offset_view(x) for x in rows)):
                before = kernels.LAUNCHES["split_midpoint"]
                ok = kernels.split_midpoint(vert, *a)
                ok0 = kernels.split_midpoint_plain(vert, *a)
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["split_midpoint"] == before + (n > 0)
                assert ok.shape == (n,) and torch.equal(ok, ok0)

        mesh = gen.unit_cube_mesh(4, dtype=dt, device=dev)
        P = mesh.pcap
        # (shards, or None for an unstacked call; rows a shard)
        cases = [(None, n) for n in sizes] + [(1, T + 37), (3, 0), (3, 1),
                                              (3, 2 * T + 3)]
        for D, Q in cases:
            d = D or 1
            pick = torch.as_tensor(rng.integers(0, int(mesh.ntet), (d, Q)),
                                   device=dev)
            vids = mesh.tet[pick].contiguous()
            pts = torch.tensor(rng.uniform(0.0, 1.0, (d, Q, 3)), dtype=dt,
                               device=dev)
            vt = torch.stack([mesh.vert + 0.1 * s for s in range(d)])
            met = torch.tensor(rng.uniform(0.05, 0.4, (d, P, 1)), dtype=dt,
                               device=dev)
            if D is None:
                vids, pts, vt, met = vids[0], pts[0], vt[0], met[0]
            for vi, pt in ((vids, pts), (_offset_view(vids),
                                         _offset_view(pts))):
                before = kernels.LAUNCHES["interp_bary"]
                b, m = kernels.interp_bary(vt, met, vi, pt)
                b0, m0 = kernels.interp_bary_plain(vt, met, vi, pt)
                torch.cuda.synchronize()
                assert kernels.LAUNCHES["interp_bary"] == before + (Q > 0)
                assert b.shape == vi.shape and m.shape == vi.shape[:-1] + (1,)
                assert torch.equal(b, b0) and torch.equal(m, m0)
