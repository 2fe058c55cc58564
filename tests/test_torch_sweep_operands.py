"""The friction sweeps' launch route on the CPU: `sweep_operands` validates a
step's slot geometry and masses once (shapes, dtypes, device, contiguity,
shared-memory fit) and caches the kernels' argument struct; the wrappers
then check only the per-call state and selects against it.  Bad operands
raise ValueError at validation, bad per-call tensors at the call, on CPU
tensors as on card tensors (the checks are pure Python).  The kernels
themselves are held to the plain versions in test_torch_cuda_kernels.py.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from diffcloth_tpu_torch.core import friction_cuda as fc
from diffcloth_tpu_torch.core import selfcol_cuda as scd
from diffcloth_tpu_torch.core.selfcol import SelfContactTables

N, B = 130, 3
BUDGETS = (128, 64)     # TC = 256, two layers


@pytest.fixture(scope="module")
def step():
    """A step's slot geometry and masses on the CPU, with contact."""
    rng = np.random.RandomState(11)
    x = torch.as_tensor(rng.randn(B, N, 3) * 0.4, dtype=torch.float32)
    v = torch.as_tensor(rng.randn(B, N, 3) * 0.3, dtype=torch.float32)
    radii = torch.as_tensor(rng.rand(N) * 0.1 + 0.05, dtype=torch.float32)
    allowed = torch.as_tensor(scd.pack_allowed(~np.eye(N, dtype=bool)))
    area = torch.as_tensor(rng.rand(N) + 0.2, dtype=torch.float32)
    tables, _ = scd.detect_tables(allowed, radii, x, v, 0.05, 8, 16)
    geom = fc.build_kernel_geom(tables, area, N, BUDGETS, x=x)
    assert int(geom.counts.sum()) > 0
    masses = fc.slot_masses(geom, torch.full((B,), 0.3))
    return geom, masses


def test_sweep_operands_cache_the_kernels_arguments(step):
    geom, masses = step
    ops = fc.sweep_operands(geom, masses, BUDGETS, N)
    TC = geom.idx_row.shape[1]
    assert ops.state_shape == (B, N, 3) and ops.vals_shape == (B, 6, TC)
    a = ops.args.contents
    assert (a.L, a.B, a.n, a.TC, a.max_c_pad) == (2, B, N, TC, 128)
    ptrs = [geom.idx_row, geom.idx_part, geom.normalT, *masses, geom.counts]
    assert [a.idx_row, a.idx_part, a.normalT, a.kred, a.imr, a.imp,
            a.counts] == [t.data_ptr() for t in ptrs]
    # friction::SweepGeom: eight pointers, then five ints
    assert fc._SweepArgs.L.offset == 64
    assert ctypes.sizeof(fc._SweepArgs) == 88


def test_wrappers_on_cpu_run_the_plain_versions(step):
    geom, masses = step
    ops = fc.sweep_operands(geom, masses, BUDGETS, N)
    rng = np.random.RandomState(12)
    f = torch.as_tensor(rng.randn(B, N, 3), dtype=torch.float32)
    out, vals = fc.friction_sweep(f, ops)
    out_p, vals_p = fc.friction_sweep_plain(f, geom, *masses, BUDGETS)
    assert torch.equal(out, out_p) and torch.equal(vals, vals_p)
    assert float((out - f).abs().max()) > 0, "friction never acted"
    g = torch.as_tensor(rng.randn(B, N, 3), dtype=torch.float32)
    for a, b in zip(fc.friction_sweep_bwd(g, vals, ops),
                    fc.friction_sweep_bwd_plain(g, geom, *masses, vals,
                                                BUDGETS)):
        assert torch.equal(a, b)


def test_single_geometry_becomes_a_batch_of_one(step):
    geom, masses = step
    one = fc.KernelGeom(**{f.name: getattr(geom, f.name)[1]
                           for f in dataclasses.fields(geom)})
    ops = fc.sweep_operands(one, [m[1] for m in masses], BUDGETS, N)
    assert ops.state_shape == (1, N, 3)
    f = torch.as_tensor(np.random.RandomState(13).randn(N, 3),
                        dtype=torch.float32)
    r = fc.self_friction(f, ops, torch.zeros_like(f))
    full = fc.self_friction(f.expand(B, N, 3),
                            fc.sweep_operands(geom, masses, BUDGETS, N),
                            torch.zeros(B, N, 3))
    assert torch.equal(r, full[1])


def _noncontig(t):
    """The same values in a non-contiguous tensor of the same shape."""
    return t.transpose(0, -1).contiguous().transpose(0, -1)


BAD_OPERANDS = {
    "idx_row_int64": lambda g, m: (dataclasses.replace(
        g, idx_row=g.idx_row.long()), m, BUDGETS, N),
    "normalT_float64": lambda g, m: (dataclasses.replace(
        g, normalT=g.normalT.double()), m, BUDGETS, N),
    "normalT_noncontiguous": lambda g, m: (dataclasses.replace(
        g, normalT=_noncontig(g.normalT)), m, BUDGETS, N),
    "counts_of_another_depth": lambda g, m: (dataclasses.replace(
        g, counts=g.counts[:, :1].contiguous()), m, BUDGETS, N),
    "k_red_float64": lambda g, m: (g, (m[0].double(), m[1], m[2]),
                                   BUDGETS, N),
    "inv_m_row_noncontiguous": lambda g, m: (g, (m[0], _noncontig(m[1]),
                                                 m[2]), BUDGETS, N),
    "inv_m_part_on_another_device": lambda g, m: (
        g, (m[0], m[1], m[2].to("meta")), BUDGETS, N),
    "masses_of_another_batch": lambda g, m: (
        g, tuple(t[:2].contiguous() for t in m), BUDGETS, N),
    "budgets_of_another_TC": lambda g, m: (g, m, (128, 64, 64), N),
    "state_beyond_shared_memory": lambda g, m: _slots_filling_smem(20000),
}


def _slots_filling_smem(n):
    """A state of n = 20000 alone now takes the global-state route
    (test_sweep_operands_take_the_global_route_past_shared_memory); what
    stays refused is a state
    beyond shared memory whose slot rows alone exceed it too (one layer of
    4224 slots: 14 staged rows of it take 236 544 bytes)."""
    budgets = (4224,)
    TC = 4224
    geom = fc.KernelGeom(
        idx_row=torch.full((B, TC), -1, dtype=torch.int32),
        idx_part=torch.full((B, TC), -1, dtype=torch.int32),
        normalT=torch.zeros((B, 3, TC)), area_row=torch.zeros((B, TC)),
        area_part=torch.zeros((B, TC)),
        counts=torch.zeros((B, 1), dtype=torch.int32),
        overflow=torch.zeros(B, dtype=torch.bool))
    return geom, fc.slot_masses(geom, torch.full((B,), 0.3)), budgets, n


@pytest.mark.parametrize("case", sorted(BAD_OPERANDS))
def test_sweep_operands_reject_what_the_kernels_do_not_take(step, case):
    geom, masses = step
    with pytest.raises(ValueError):
        fc.sweep_operands(*BAD_OPERANDS[case](geom, masses))


BAD_CALLS = {
    "fr_float64": lambda f, v, ops: fc.friction_sweep(f.double(), ops),
    "fr_noncontiguous": lambda f, v, ops: fc.friction_sweep(_noncontig(f),
                                                            ops),
    "fr_of_another_width": lambda f, v, ops: fc.friction_sweep(
        f[:, 1:].contiguous(), ops),
    "g_of_another_batch": lambda f, v, ops: fc.friction_sweep_bwd(
        f[:2].contiguous(), v, ops),
    "vals_of_three_rows": lambda f, v, ops: fc.friction_sweep_bwd(
        f, v[:, :3].contiguous(), ops),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrappers_reject_a_bad_state_per_call(step, case):
    geom, masses = step
    ops = fc.sweep_operands(geom, masses, BUDGETS, N)
    f = torch.zeros((B, N, 3))
    vals = torch.zeros(ops.vals_shape)
    with pytest.raises(ValueError):
        BAD_CALLS[case](f, vals, ops)


def test_sweep_operands_take_the_global_route_past_shared_memory():
    """At the large-mesh scene's n = 16 384 the (n, 3) state does not fit
    the backward block's shared memory beside its slot rows: the operands
    pick the global-state route instead of raising, and the wrappers still
    run the plain versions on CPU tensors.  The route changes where the
    largest n with the state in shared memory stops."""
    budgets = (256, 128, 64, 64)
    specs, TC = fc.layer_specs(budgets)
    last_shared = max(k for k in range(1, 20000)
                      if fc._smem_bytes(k, TC, 256, 4, *fc.BWD_SMEM_ROWS)
                      <= fc.SMEM_LIMIT)
    assert 15000 < last_shared < 16384
    rng = np.random.RandomState(14)
    for n, route in ((16384, "global"), (last_shared + 1, "global"),
                     (last_shared, "shared"), (1024, "shared")):
        nb = 2
        partner = torch.full((nb, 16, n), -1, dtype=torch.int64)
        rows = torch.arange(300)
        partner[:, 0, rows] = rows + n // 2      # 300 pairs in layer 0:
        partner[:, 0, rows + n // 2] = rows      # 600 rows, over budget
        tables = SelfContactTables(
            partner=partner, n_layers=torch.ones(nb, dtype=torch.int64))
        x = torch.as_tensor(rng.randn(nb, n, 3), dtype=torch.float32)
        geom = fc.build_kernel_geom(tables, torch.ones(n), n, budgets, x=x)
        masses = fc.slot_masses(geom, torch.full((nb,), 0.3))
        ops = fc.sweep_operands(geom, masses, budgets, n)
        assert ops.route == route and ops.state_shape == (nb, n, 3)
        assert bool(geom.overflow.all()) and int(geom.counts[0, 0]) == 256
        if n != 16384:
            continue
        f = torch.as_tensor(rng.randn(nb, n, 3), dtype=torch.float32)
        out, vals = fc.friction_sweep(f, ops)
        out_p, vals_p = fc.friction_sweep_plain(f, geom, *masses, budgets)
        assert torch.equal(out, out_p) and torch.equal(vals, vals_p)
        assert float((out - f).abs().max()) > 0, "friction never acted"
        g = torch.as_tensor(rng.randn(nb, n, 3), dtype=torch.float32)
        for a, b in zip(fc.friction_sweep_bwd(g, vals, ops),
                        fc.friction_sweep_bwd_plain(g, geom, *masses, vals,
                                                    budgets)):
            assert torch.equal(a, b)
