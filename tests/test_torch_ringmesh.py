"""The port's ring across devices, module by module, on the CPU: ranks are
processes over gloo (NGSLD_PLATFORM=cpu), held against the JAX package's
ring on its 8 virtual CPU devices (tests/conftest.py) on the same numpy
inputs, made from a seed:

  * Mesh.ring_shift at offsets 1-3 on four blocks, and within the 'ind'
    columns of a 2 x 2 mesh, against jax.lax.ppermute; the gather taker's
    fast-forward against the reference's taker (exact);
  * the gather stepper on four blocks over steps t = 0..2 and sub-rings
    si = 0, 1, sampled and not, with --ignore_miss_data and without,
    against ring_sweep_stepper(..., compact_cfg=...) in f64: nIter and
    n_used exact, f and r2p within 1e-12, the live count equal;
  * the strip stepper (its plain version here) on four blocks over two
    steps against ring_sweep_stepper_strip(..., interpret=True), at the
    reference's strip contract (tests/test_pallas_strip.py:590-601: n_used
    exact, nIter within 1 on more than 95% of rows, hap freqs within 3e-5
    where nIter is equal and under the cap, r2p within 2e-5);
  * ring_sweep_stepper_ind on a 2 x 2 world against the reference's on a
    (2, 2) mesh, f64 (nIter and n_used exact, f and r2p within 1e-12);
  * the all-steps ring_sweep on four blocks against the reference's, on
    the case of tests/test_parallel.py:100, f64.

One world of four ranks (this process is rank 0) computes every case;
the JAX package is imported inside the tests, so that the spawned ranks
stay free of it."""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ngsld_tpu_torch import strict as tstrict
from ngsld_tpu_torch.kernels import strip_em as tstrip
from ngsld_tpu_torch.parallel import mesh as tmesh
from ngsld_tpu_torch.parallel import ring as tring
from ngsld_tpu_torch.utils.simulate import simulate

WORLD = 4
OFFSETS = (1, 2, 3)
# (si, --rnd_sample, --ignore_miss_data)
GATHER_CASES = ((0, False, False), (1, False, False), (0, True, True),
                (1, True, True))
IND_CASES = ((0, False, False), (1, True, True))
STRIP_CASES = (False, True)          # --ignore_miss_data


@pytest.fixture(autouse=True)
def cpu_and_two_threads(monkeypatch):
    monkeypatch.setenv("NGSLD_PLATFORM", "cpu")
    # the ranks share this process's threads: the 2-thread cap of the heavy
    # test files keeps 6 workers x N ranks off each other's cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ inputs

def _tables(S, I, seed, missing):
    """gn (S, I, 3) normal-space GLs, eg (S, I), maf (S,): f64."""
    sim = simulate(n_ind=I, n_sites=S, seed=seed,
                   all_missing_site_rate=missing)
    gn = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    eg = gn[..., 1] + 2 * gn[..., 2]
    return gn, eg, eg.mean(axis=1) / 2


def _bits(rng, n_dev, area):
    """A random membership plane a block, packed as the engine packs it:
    (n_dev, CAPW) u32 words (the port reads their bytes)."""
    capw = -(-area // 32)
    words = np.zeros((n_dev, capw), np.uint32)
    for k in range(n_dev):
        by = np.packbits(rng.random(area) < 0.5, bitorder="little")
        words[k] = np.pad(by, (0, capw * 4 - len(by))).view(np.uint32)
    return words


def _ring_case(n, n_dev, B, B_sub, I, seed, sample, ign, band, steps):
    """Tables of n sites in n_dev blocks of B, band limits hi, ok plane,
    the compact_cfg of the steppers, and a bits plane a step."""
    S = n_dev * B
    gn, eg, maf = _tables(S, I, seed, 0.05 if ign else 0.0)
    rng = np.random.default_rng(seed)
    hi = np.zeros(S, np.int32)
    hi[:n] = np.minimum(np.arange(n) + rng.integers(1, band, n), n)
    ok = np.zeros(S, np.float32)
    ok[:n] = rng.random(n) < 0.9
    cfg = dict(n=n, B=B, B_sub=B_sub, n_dev=n_dev, sample=sample,
               slim_im=not ign, use_i16=True)
    bits = [_bits(rng, n_dev, B * B_sub) for _ in range(steps)]
    return dict(gn=gn, eg=eg, maf=maf, hi=hi, ok=ok, cfg=cfg, bits=bits)


def _gather_case(si, sample, ign):
    # 120 sites in 4 blocks of 32, two sub-blocks of 16; bands reach two
    # blocks on, so steps t = 0..2 all hold live cells
    return _ring_case(120, 4, 32, 16, 8, 11 + 2 * si + sample, sample, ign,
                      70, 3)


def _ind_case(si, sample, ign):
    # 60 sites in 2 blocks of 32 (2 sub-blocks of 16), 8 individuals over
    # 2 'ind' ranks
    return _ring_case(60, 2, 32, 16, 8, 31 + si, sample, ign, 40, 2)


def _strip_case(ign):
    # 500 sites in 4 blocks of one 128-site tile; two steps
    c = _ring_case(500, 4, 128, 128, 6, 19 + ign, False, ign, 220, 2)
    c["maf"] = c["maf"].astype(np.float32)
    return c


SWEEP = dict(S=32, I=12, B=8, steps=3)      # tests/test_parallel.py:100


def _sweep_case():
    rng = np.random.default_rng(4)
    gl = rng.dirichlet([2.0, 1.5, 1.0], size=(SWEEP["S"], SWEEP["I"]))
    eg = gl[..., 1] + 2 * gl[..., 2]
    return gl, eg, eg.mean(axis=1) / 2


def _shift_inputs(rank):
    """Three tensors of different dtypes whose values name their rank."""
    rng = np.random.default_rng(100 + rank)
    return (rng.random((5, 3)), rng.random(7).astype(np.float32),
            rng.integers(0, 1 << 40, (2, 2)))


# ------------------------------------------------- the port on four ranks

def _resident(x, m, B, spare=0, cols=slice(None)):
    """This rank's block of a site-major array, with `spare` visiting rows
    past it (the gather steppers' slots), as a torch tensor."""
    blk = np.asarray(x[m.pi * B:(m.pi + 1) * B])[:, cols] if x.ndim > 1 \
        else np.asarray(x[m.pi * B:(m.pi + 1) * B])
    out = np.zeros((B + spare,) + blk.shape[1:], blk.dtype)
    out[:B] = blk
    return torch.from_numpy(out)


def _steps(taker, step, tabs, c, si, n_steps, m):
    """Run `n_steps` ring steps of sub-ring si: [(fm, im, cnt) a step]."""
    vis = taker(*tabs[:3], tabs[4])
    out = []
    for t in range(n_steps):
        bits = (torch.from_numpy(c["bits"][t][m.pi].view(np.uint8))
                if c["cfg"]["sample"] else None)
        (fm, im, cnt), *vis = step(*tabs, *vis, t, si, bits)
        out.append((fm.numpy(), im.numpy(), cnt))
    return out


def _port_side(rank, store, out_dir):
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    m = tmesh.connect(rank, WORLD, WORLD, 1, cpu, WORLD, store)
    # the same world read as 2 site blocks x 2 'ind' ranks
    rows = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    m22 = tmesh.Mesh(rank, WORLD, 2, 2, cpu, "gloo", False, WORLD,
                     ind_group=rows[rank // 2], host_group=m.host_group)
    t = torch.from_numpy
    res = {}
    try:
        mine = [t(x) for x in _shift_inputs(rank)]
        for k in OFFSETS:
            res["shift", k] = [x.numpy() for x in m.ring_shift(mine, k)]
        res["shift22"] = [x.numpy() for x in m22.ring_shift(mine)]
        res["shift_counts"] = (m.ring_exchanges, m.ring_exchange_bytes)

        for si, sample, ign in GATHER_CASES:
            c = _gather_case(si, sample, ign)
            cfg = c["cfg"]
            B, B_sub = cfg["B"], cfg["B_sub"]
            tabs = [_resident(c[k], m, B, 2 * B_sub)
                    for k in ("gn", "eg", "maf")]
            tabs += [_resident(c["hi"], m, B), _resident(c["ok"], m, B)]
            res["gather", si, sample, ign] = _steps(
                tring.ring_subblock_taker(4, 2, si, with_ok=True, mesh=m),
                tring.ring_sweep_stepper(ign, 37, cfg, m), tabs, c, si, 3,
                m)
            if (si, sample, ign) == GATHER_CASES[-1]:
                # the taker's fast-forward: one shift of `offset`
                res["taker"] = [x.numpy() for x in tring.ring_subblock_taker(
                    4, 2, si, offset=3, with_ok=True, mesh=m)(
                        *tabs[:3], tabs[4])]

        for ign in STRIP_CASES:
            c = _strip_case(ign)
            cfg = c["cfg"]
            B = cfg["B"]
            ga, gb, ea, eb = tstrip.strip_tables(
                _resident(c["gn"], m, B), _resident(c["eg"], m, B), 6)
            vis_take = tring.ring_subblock_taker_strip(4, 1, 0, mesh=m)
            step = tring.ring_sweep_stepper_strip(6, B, B, ign, cfg, m)
            maf, hi, ok = (_resident(c[k], m, B) for k in ("maf", "hi", "ok"))
            vis = vis_take(gb, eb, maf, ok)
            out = []
            for s in range(2):
                (fm, im, cnt), *vis = step(ga, ea, hi, ok, maf, *vis, s, 0)
                out.append((fm.numpy(), im.numpy(), cnt))
            res["strip", ign] = out

        for si, sample, ign in IND_CASES:
            c = _ind_case(si, sample, ign)
            cfg = c["cfg"]
            B, B_sub = cfg["B"], cfg["B_sub"]
            cols = slice(m22.ii * 4, (m22.ii + 1) * 4)
            tabs = [_resident(c["gn"], m22, B, 2 * B_sub, cols),
                    _resident(c["eg"], m22, B, 2 * B_sub, cols),
                    _resident(c["maf"], m22, B, 2 * B_sub),
                    _resident(c["hi"], m22, B), _resident(c["ok"], m22, B)]
            n0 = m22.allreduces
            res["ind", si, sample, ign] = _steps(
                tring.ring_subblock_taker(2, 2, si, with_ok=True, mesh=m22),
                tring.ring_sweep_stepper_ind(ign, 37, cfg, m22), tabs, c,
                si, 2, m22) + [m22.allreduces - n0]

        gl, eg, maf = _sweep_case()
        B = SWEEP["B"]
        res["sweep"] = tring.ring_sweep(SWEEP["steps"], mesh=m)(
            *(_resident(x, m, B) for x in (gl, eg, maf)))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        tmesh.teardown()


def _child(rank, port, out_dir):
    store = dist.TCPStore(tmesh.HOST, port, WORLD, False,
                          timeout=datetime.timedelta(seconds=120))
    _port_side(rank, store, out_dir)


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    """One world of four ranks (this process is rank 0) for every case."""
    import torch.multiprocessing as mp
    out = str(tmp_path_factory.mktemp("ringranks"))
    store = dist.TCPStore(tmesh.HOST, 0, WORLD, True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=120))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, store.port, out))
             for r in range(1, WORLD)]
    for p in procs:
        p.start()
    n = torch.get_num_threads()
    try:
        _port_side(0, store, out)
    finally:
        torch.set_num_threads(n)
        for p in procs:
            p.join(120)
    assert [p.exitcode for p in procs] == [0] * (WORLD - 1)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


# ------------------------------------------------------- the JAX side

def _jmesh(shape=(4,), names=("sites",)):
    import jax
    return jax.sharding.Mesh(
        np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _equal_nan(a, b, atol):
    nan = np.isnan(a) & np.isnan(b)
    np.testing.assert_allclose(np.where(nan, 0, a), np.where(nan, 0, b),
                               atol=atol, rtol=0)


# ------------------------------------------------------------- ring_shift

def test_ring_shift_matches_ppermute(port_side):
    """Offsets 1-3 on four blocks, and offset 1 within each 'ind' column
    of a 2 x 2 mesh, against ppermute over 'sites' (exact); each shift is
    counted with the bytes this rank sent."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    glob = [np.concatenate([_shift_inputs(r)[k] for r in range(WORLD)])
            for k in range(3)]

    def permuted(mesh, spec, offset, n):
        perm = [(k, (k - offset) % n) for k in range(n)]
        fn = jax.jit(shard_map(
            lambda *xs: tuple(jax.lax.ppermute(x, "sites", perm)
                              for x in xs),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 3,
            check_vma=False))
        with jax.enable_x64(True):
            return [np.asarray(x) for x in fn(*map(jax.numpy.asarray,
                                                   glob))]

    def block(jx, r):
        rows = len(jx) // WORLD
        return jx[r * rows:(r + 1) * rows]

    for k in OFFSETS:
        j = permuted(_jmesh(), P("sites"), k, WORLD)
        for r in range(WORLD):
            for x, jx in zip(port_side[r]["shift", k], j):
                np.testing.assert_array_equal(x, block(jx, r))
                assert x.dtype == jx.dtype
    # 2 x 2: rank r = 2 * site block + 'ind' rank holds row block r of an
    # axis split over ('sites', 'ind'); the shift runs within a column
    j = permuted(_jmesh((2, 2), ("sites", "ind")), P(("sites", "ind")), 1,
                 2)
    for r in range(WORLD):
        for x, jx, mine in zip(port_side[r]["shift22"], j,
                               _shift_inputs(r)):
            np.testing.assert_array_equal(x, block(jx, r))
            assert not np.array_equal(x, mine)
        n_b = sum(x.nbytes for x in _shift_inputs(r))
        assert port_side[r]["shift_counts"] == (3, 3 * n_b)


def test_taker_fast_forward_matches_jax(port_side):
    """ring_subblock_taker(offset=3): sub-block si of block i + 3, in one
    shift, against the reference's taker on the same tables."""
    import jax
    from ngsld_tpu.parallel import ring as jring
    si, sample, ign = GATHER_CASES[-1]
    c = _gather_case(si, sample, ign)
    with jax.enable_x64(True):
        j = [np.asarray(x) for x in jring.ring_subblock_taker(
            _jmesh(), 2, si, offset=3, with_ok=True)(
                *(jax.numpy.asarray(c[k]) for k in ("gn", "eg", "maf",
                                                    "ok")))]
    for r in range(WORLD):
        for x, jx in zip(port_side[r]["taker"], j):
            rows = len(jx) // WORLD
            np.testing.assert_array_equal(x, jx[r * rows:(r + 1) * rows])


# ------------------------------------------------------------- steppers

def _jax_steps(step, taker, c, si, n_steps, tabs):
    """The reference's stepper over steps 0..n_steps-1 of sub-ring si:
    [(fm (n_dev, CAP, 5), im, cnt (n_dev,)) a step]."""
    import jax
    jnp = jax.numpy
    vis = taker(*tabs[:3], tabs[4])
    out = []
    for t in range(n_steps):
        extra = [jnp.asarray(c["bits"][t])] if c["cfg"]["sample"] else []
        (fm, im, cnt), *vis = step(*tabs, *vis, jnp.int32(t), jnp.int32(si),
                                   *extra)
        out.append((np.asarray(fm), np.asarray(im), np.asarray(cnt)))
    return out


def _hold(port, j, n_blocks, ranks, f_tol, exact_it=True, strict=None):
    """Each block's rows of each step: the live count equal, then n_used
    (and nIter) exact and fm within f_tol, or the strip contract. Under
    the strip contract, strict(t, k, rows) gives the port's strict f64 EM
    (f, nIter) on the pairs of block k's rows `rows` at step t: the rows
    whose nIter part from the reference's or sit at the cap are held
    against it."""
    live = 0
    for t, (jfm, jim, jcnt) in enumerate(j):
        for k in range(n_blocks):
            fm, im, cnt = port[ranks[k]][t]
            assert cnt == int(jcnt[k]), (t, k)
            live += cnt
            if not cnt:
                continue
            jf, ji = jfm[k, :cnt], jim[k, :cnt]
            assert fm.dtype == jf.dtype and im.dtype == ji.dtype
            if im.shape[1] > 1:
                np.testing.assert_array_equal(im[:, 1], ji[:, 1])
            if exact_it:
                np.testing.assert_array_equal(im, ji)
                _equal_nan(fm, jf, f_tol)
            else:
                it = im[:, 0].astype(int)
                assert (np.abs(it - ji[:, 0]) <= 1).mean() > 0.95
                # a pair at the iteration cap never converged: its f32
                # (reference) and f64 (port) trajectories part there, so
                # it is held against strict's f64 EM instead, at the cap
                # there too (as is a pair whose nIter parts by one)
                same = (it == ji[:, 0]) & (it < 100)
                assert same.mean() > 0.95
                _equal_nan(fm[same, 1:], jf[same, 1:], 3e-5)
                _equal_nan(fm[:, 0], jf[:, 0], 2e-5)
                rest = np.flatnonzero(~same)
                sf, sit = strict(t, k, rest)
                _equal_nan(fm[rest, 1:], sf, 3e-5)
                at_cap = it[rest] == 100
                assert (sit[at_cap] == 100).all()
                assert (np.abs(sit - it[rest]) <= 1).all()
    return live


@pytest.mark.parametrize("si,sample,ign", GATHER_CASES)
def test_gather_stepper_matches_jax(port_side, si, sample, ign):
    """Four blocks, steps t = 0..2: the port's gather stepper (live cells
    through compute_block in pieces of 37 pairs, partners in the visiting
    slots) against the reference's compacted XLA stepper, f64."""
    import jax
    from ngsld_tpu.parallel import ring as jring
    c = _gather_case(si, sample, ign)
    with jax.enable_x64(True):
        tabs = [jax.numpy.asarray(c[k]) for k in ("gn", "eg", "maf", "hi",
                                                  "ok")]
        j = _jax_steps(
            jring.ring_sweep_stepper(_jmesh(), ign, True, row_chunk=256,
                                     compact_cfg=c["cfg"]),
            jring.ring_subblock_taker(_jmesh(), 2, si, with_ok=True), c, si,
            3, tabs)
    port = [p["gather", si, sample, ign] for p in port_side]
    live = _hold(port, j, 4, range(4), 1e-12)
    # every step held rows somewhere, so the visiting state was used
    assert live > 200 and all(int(x[2].sum()) for x in j)


@pytest.mark.parametrize("ign", STRIP_CASES)
def test_strip_stepper_matches_jax(port_side, ign):
    """Four blocks of one tile, steps 0 and 1 (shifted bounds below 0 and
    past the sub-block): the port's strip stepper (plain version) against
    the reference's Pallas strip stepper in interpret mode."""
    import jax
    from ngsld_tpu.kernels import pallas_strip as jstrip
    from ngsld_tpu.parallel import ring as jring
    c = _strip_case(ign)
    jnp = jax.numpy
    with jax.enable_x64(False):
        ga, gb, ea, eb = jstrip.strip_tables(
            jnp.asarray(c["gn"], jnp.float32),
            jnp.asarray(c["eg"], jnp.float32), n_ind=6)
        maf, hi, ok = (jnp.asarray(c[k]) for k in ("maf", "hi", "ok"))
        step = jring.ring_sweep_stepper_strip(
            _jmesh(), 6, 128, 128, ign, True, interpret=True,
            compact_cfg=c["cfg"])
        vis = jring.ring_subblock_taker_strip(_jmesh(), 1, 0)(gb, eb, maf,
                                                               ok)
        j = []
        for t in range(2):
            (fm, im, cnt), *vis = step(ga, ea, hi, ok, maf, *vis,
                                       jnp.int32(t), jnp.int32(0))
            j.append((np.asarray(fm), np.asarray(im), np.asarray(cnt)))
    port = [p["strip", ign] for p in port_side]
    B, n = c["cfg"]["B"], c["cfg"]["n"]
    # the f32 tables' GLs and MAFs, widened: what the port's EM reads
    gl = c["gn"].astype(np.float32).astype(np.float64)
    maf = c["maf"].astype(np.float64)

    def strict(t, k, rows):
        # block k's step-t emission mask (parallel/ring.py::_tile_mask):
        # its rows are the valid cells in row-major (a, pj) order
        A = (k * B + np.arange(B))[:, None]
        PJ = (((k + t) % 4) * B + np.arange(B))[None, :]
        valid = (PJ > A) & (PJ < n) & (A < n) & (c["ok"][A] > 0) \
            & (c["ok"][PJ] > 0) & (PJ < c["hi"][A])
        a, pj = np.nonzero(valid)
        assert len(a) == port[k][t][2]
        s1, s2 = A[a[rows], 0], PJ[0, pj[rows]]
        f, n_iter, _ = tstrict.pair_em_batch(gl[s1], gl[s2], maf[s1],
                                             maf[s2], ign)
        return f, n_iter

    assert _hold(port, j, 4, range(4), None, exact_it=False,
                 strict=strict) > 20000


@pytest.mark.parametrize("si,sample,ign", IND_CASES)
def test_ind_stepper_matches_jax(port_side, si, sample, ign):
    """ring_sweep_stepper_ind on 2 site blocks x 2 'ind' ranks, steps 0
    and 1, against the reference's on a (2, 2) ('sites', 'ind') mesh, f64;
    both ranks of a block return the same rows, and the all-reduces were
    counted."""
    import jax
    from ngsld_tpu.parallel import ring as jring
    c = _ind_case(si, sample, ign)
    mesh = _jmesh((2, 2), ("sites", "ind"))
    with jax.enable_x64(True):
        tabs = [jax.numpy.asarray(c[k]) for k in ("gn", "eg", "maf", "hi",
                                                  "ok")]
        j = _jax_steps(
            jring.ring_sweep_stepper_ind(mesh, ign, True, row_chunk=256,
                                         compact_cfg=c["cfg"]),
            jring.ring_subblock_taker_ind(mesh, 2, si, with_ok=True), c, si,
            2, tabs)
    port = [p["ind", si, sample, ign] for p in port_side]
    for b in (0, 2):
        for (fa, ia, ca), (fb, ib, cb) in zip(port[b][:2], port[b + 1][:2]):
            np.testing.assert_array_equal(fa, fb)
            np.testing.assert_array_equal(ia, ib)
            assert ca == cb
        assert port[b][2] == port[b + 1][2] > 2
    assert _hold([p[:2] for p in port], j, 2, (0, 2), 1e-12) > 50


# ------------------------------------------------------------- ring_sweep

def test_ring_sweep_matches_jax(port_side):
    """The all-steps sweep on four blocks, three steps, f64: every
    statistic of every (a, partner) cell against the reference's
    ring_sweep; nIter and n_used exact, f, r2p, hap MAFs and D within
    1e-12, D', r2 and chi2 those of the port's f."""
    import jax
    from ngsld_tpu.ops.stats import chi2_stat, ld_stats
    from ngsld_tpu.parallel import ring as jring
    from ngsld_tpu_torch.engine_ring import _local_blocks
    gl, eg, maf = _sweep_case()
    with jax.enable_x64(True):
        j = {k: np.asarray(v) for k, v in jring.ring_sweep(
            _jmesh(), n_steps=SWEEP["steps"], ignore_miss_data=False)(
                *(jax.numpy.asarray(x) for x in (gl, eg, maf))).items()}
    B = SWEEP["B"]
    assert set(port_side[0]["sweep"]) == set(j) == set(tring._STAT_KEYS)
    for r in range(WORLD):
        out = port_side[r]["sweep"]
        # D', r2 and chi2 divide by products of the haplotype margins, so
        # near a monomorphic site a 1e-16 move of f moves them by up to
        # 0.1: they are held bit-equal to the reference's ld_stats and
        # chi2_stat of the port's own f (f itself within 1e-12)
        with jax.enable_x64(True):
            f = jax.numpy.asarray(out["f"].reshape(-1, 4))
            _, _, _, dp, r2 = ld_stats(f)
            ratios = dict(Dp=dp, r2=r2, chi2=chi2_stat(f))
        for k, v in j.items():
            jv = v[:, r * B:(r + 1) * B]
            assert out[k].shape == jv.shape, k
            if k in ("n_iter", "n_used"):
                np.testing.assert_array_equal(out[k], jv)
            elif k in ratios:
                _equal_nan(out[k], np.asarray(ratios[k]).reshape(jv.shape),
                           0)
                assert out[k].dtype == jv.dtype
            else:
                _equal_nan(out[k], jv, 1e-12)
    m = tmesh.Mesh(2, WORLD, WORLD, 1, torch.device("cpu"), "gloo", False)
    assert list(_local_blocks(torch.zeros(3), m)) == [2]


# ---------------------------------------------- the spill of two processes

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_two_process_spill_reads_across_packages(tmp_path, writer):
    """A two-process ring spill (procs 0 and 1, each its own block, filled
    directly with no run) written by one package's _RingSpill is read by
    the other's: the same manifest (so the same fingerprint of a
    multi-process decomposition), the same committed steps, the same tile
    files and records, and no proc reads the other's tiles."""
    from ngsld_tpu import checkpoint as j_ckpt
    from ngsld_tpu.cli import params_from_args as j_params
    from ngsld_tpu_torch import checkpoint as t_ckpt
    from ngsld_tpu_torch.cli import params_from_args as t_params
    from ngsld_tpu_torch.strict import StrictError
    from ngsld_tpu_torch.utils.simulate import write_all
    files = write_all(simulate(n_ind=4, n_sites=40, seed=3),
                      str(tmp_path / "fx"))
    argv = ["--geno", files["beagle"], "--probs", "--n_ind", "4",
            "--n_sites", "40", "--pos", files["pos"], "--ring", "--shard",
            "2", "--checkpoint", str(tmp_path / "ck")]
    pars = dict(jax=j_params(argv), port=t_params(argv))
    cls = dict(jax=j_ckpt._RingSpill, port=t_ckpt._RingSpill)
    reader = "port" if writer == "jax" else "jax"
    extra = dict(mode="ring", n_dev=2, n_sub=2, block=20, n_proc=2,
                 strip=False, n_is=1, cols="slim-v2", prec="f64")
    d = str(tmp_path / "ck")
    rng = np.random.default_rng(9)
    tiles = {}
    for proc in (0, 1):
        w = cls[writer](d, pars[writer], extra, proc, True)
        for si, t in ((0, 0), (0, 1), (1, 0)):
            if proc == 1 and (si, t) == (1, 0):
                continue        # proc 1 died before committing this step
            k = 1 + si + t
            cols = dict(a=np.full(k, 20 * proc, np.int32),
                        pj=np.arange(k, dtype=np.int32) + 21,
                        r2p=rng.random(k), f=rng.random((k, 4)),
                        n_iter=rng.integers(0, 100, k).astype(np.int8))
            w.save_step(si, t, {proc: cols})
            tiles[proc, si, t] = cls[writer].pack(cols)
    for proc in (0, 1):
        r = cls[reader](d, pars[reader], extra, proc, True)
        assert r.done(0, 0) and r.done(0, 1)
        assert r.done(1, 0) == (proc == 0) and not r.done(1, 1)
        paths = r.block_tiles(proc)
        assert r.block_tiles(1 - proc) == []
        want = [tiles[k] for k in sorted(tiles) if k[0] == proc]
        assert len(paths) == len(want)
        for p, rec in zip(paths, want):
            got = np.load(p)
            assert got.dtype == rec.dtype and got.tobytes() == rec.tobytes()
    # a world of another size is another decomposition
    with pytest.raises(StrictError, match="different run configuration"):
        t_ckpt._RingSpill(d, pars["port"], dict(extra, n_proc=4), 0, True)


# ------------------------------------------------------- the block loader

@pytest.mark.parametrize("route", ["binary", "text", "read_geno"])
def test_ring_loader_takes_this_ranks_block(tmp_path, monkeypatch, route):
    """loaders._ring_sharded_tables on a rank at site block 1 of 2 and
    'ind' slice 1 of 2: exactly read_geno's records of its sites and
    individuals (the binary route's raw records; several slabs), pad rows
    past n_sites and the visiting slots uniform."""
    from ngsld_tpu_torch import strict
    from ngsld_tpu_torch.cli import params_from_args
    from ngsld_tpu_torch.loaders import _ring_sharded_tables
    from ngsld_tpu_torch.utils.logging import RunLog
    from ngsld_tpu_torch.utils.simulate import write_all
    if route == "read_geno":
        monkeypatch.setenv("NGSLD_NO_FASTTEXT", "1")
    monkeypatch.setenv("NGSLD_SLAB_BYTES", "2000")   # several slabs
    n, m_ind, B, spare = 100, 6, 56, 8
    files = write_all(simulate(n_ind=m_ind, n_sites=n, seed=29),
                      str(tmp_path / "fx"))
    geno = (["--geno", files["glf"], "--log_scale"] if route == "binary"
            else ["--geno", files["beagle"], "--probs"])
    pars = params_from_args(geno + ["--n_ind", str(m_ind), "--n_sites",
                                    str(n), "--pos", files["pos"], "--ring",
                                    "--verbose", "0"])
    rank = tmesh.Mesh(3, 4, 2, 2, torch.device("cpu"), "gloo", False)
    gl, raw = _ring_sharded_tables(pars, 2, B, 2 * B, np.float64,
                                   RunLog(0), "cpu", rank, spare)
    assert raw == (route == "binary")
    assert gl.shape == (B + spare, m_ind // 2, 3)
    if raw:
        ref = np.fromfile(files["glf"], np.float64).reshape(n, m_ind, 3)
    else:
        ref = np.asarray(strict.read_geno(files["beagle"], False, True,
                                          False, m_ind, n))
    rows = n - B                                     # block 1's real sites
    np.testing.assert_array_equal(gl.numpy()[:rows], ref[B:, 3:])
    np.testing.assert_array_equal(gl.numpy()[rows:], np.log(1.0 / 3.0))
