"""The system path's transport (nomad_tpu_torch/solver/system.py) against
the per-field route and the JAX program, on the CPU.

solve_system ships one lane's tables as views of one buffer (one
host->device copy on a card), the batch at its first row only, as the
reference slices it; the kernel writes fit and score into one output
buffer that solve_system_arrays reads back with one copy. Both must give
the fit and scores of system_fit over dense.lane_tensors' per-field
tensors and of nomad_tpu/solver/binpack.py _solve_system_impl, bit for
bit, in float32 and float64, on the system eval's world (the headline
fleet of chip_smoke.py) and on the cores, ports and scarce fuzz lanes.
The upload does not touch the resident buffer set.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu.solver import binpack as ref

from nomad_tpu_torch.solver import binpack as port_bp
from nomad_tpu_torch.solver import dense, resident, system
from nomad_tpu_torch.solver.service import solve_system_arrays
from nomad_tpu_torch.tensor import pack as tp

torch.set_num_threads(1)

CPU = torch.device("cpu")
WORLDS = {"cores": ("cores",), "ports": ("ports",),
          "scarce": ("scarce", "ports", "cores")}


def _lane(world, dtype_name):
    """One fuzz lane as dicts (for the reference) and as the port's lane
    NamedTuples of numpy tables (node axis (N,), placement axis (P,))."""
    rng = np.random.default_rng(sorted(WORLDS).index(world) + 40)
    dicts = chip_smoke.dense_fuzz_tables(
        np, rng, n=200, n_pad=256, p=4, dtype=dtype_name, limit=2,
        features=WORLDS[world])
    stacked = chip_smoke.dense_group(np, port_bp, [dicts])
    return dicts, tuple(type(t)(*(np.asarray(a)[0] for a in t))
                        for t in stacked)


def _bits(t):
    t = t.contiguous()
    return t.view({1: torch.uint8, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("spread_alg", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_stacked_upload_matches_lane_tensors_and_reference(
        world, dtype_name, spread_alg):
    dicts, lane = _lane(world, dtype_name)
    tabs = system.system_tables(*lane, dtype_name=dtype_name, device=CPU)
    # one buffer, every table 16-byte aligned in it, the batch one row
    base = tabs[0].untyped_storage().data_ptr()
    for (ti, f, _, _), t in zip(system._TABLE, tabs):
        assert t.untyped_storage().data_ptr() == base, f
        assert (t.data_ptr() - base) % 16 == 0, f
        if ti == 2 and t.numel():
            assert tuple(t.shape) == (1, 1), f
    # the same tables as the per-field route (its batch at row 0)
    rows = [type(t)(*(np.asarray(a)[None] for a in t)) for t in lane]
    c, s, b = dense.lane_tensors(*rows, dtype_name=dtype_name, device=CPU)
    for (ti, f, _, _), t, r in zip(system._TABLE, tabs,
                                   system._tables_of(c, s, b)):
        want = r[:, :1] if ti == 2 and r.numel() else r
        assert t.dtype == want.dtype and torch.equal(t, want), f
    out = system.system_fit_tables(tabs, spread_alg=spread_alg)
    N = lane[0].cpu_cap.shape[0]
    dt = getattr(torch, dtype_name)
    assert out.dtype == torch.uint8 and out.numel() == N * (
        dt.itemsize + 1)
    fit, score = system.packed_views(out, 1, N, dt)
    fit_l, score_l = system.system_fit(c, s, b, spread_alg=spread_alg)
    assert torch.equal(fit, fit_l)
    assert torch.equal(_bits(score), _bits(score_l))
    want = ref.solve_system(ref.NodeConst(**dicts[0]),
                            ref.NodeState(**dicts[1]),
                            ref.PlacementBatch(**dicts[2]),
                            spread_alg=spread_alg, dtype_name=dtype_name)
    np.testing.assert_array_equal(fit[0].numpy(), np.asarray(want[0]))
    assert np.asarray(want[1]).tobytes() == score[0].numpy().tobytes()
    # solve_system's own route
    got = system.solve_system(*lane, spread_alg=spread_alg,
                              dtype_name=dtype_name, device=CPU)
    assert torch.equal(got[0], fit[0])
    assert torch.equal(_bits(got[1]), _bits(score[0]))
    assert fit.any() and not fit.all()


@pytest.fixture(scope="module")
def system_world():
    world = chip_smoke.headline_world(np, tp)
    return world, chip_smoke.system_world(np, world, chip_smoke.SEED)


@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_system_world_one_readback_matches_reference(system_world,
                                                     dtype_name):
    """chip_smoke.py's system eval (the headline fleet, ~5% of nodes
    masked, a static port taken on ~1%) through solve_system_arrays:
    per node its position where it fits and its score, equal to the
    reference's _solve_system_impl on the same lane; the resident set
    untouched."""
    (matrix, usage, _), (feas, ports_free) = system_world
    resident._reset_for_tests()
    before = resident.stats()
    lane, chosen, scores = solve_system_arrays(
        matrix, usage, feas, ask=chip_smoke.SYSTEM_ASK,
        eval_id="system-bench-eval-0000000000000000",
        state_index=chip_smoke.STATE_INDEX, static_ports_free=ports_free,
        n_dyn_ports=1, dtype_name=dtype_name, device="cpu")
    assert resident.stats() == before
    batch1 = type(lane.batch)(*(np.asarray(a)[:1] for a in lane.batch))
    fit, score = (np.asarray(x) for x in ref.solve_system(
        ref.NodeConst(**lane.const._asdict()),
        ref.NodeState(**lane.init._asdict()),
        ref.PlacementBatch(**batch1._asdict()), spread_alg=False,
        dtype_name=dtype_name))
    n = matrix.n_real
    inv = np.empty(n, dtype=np.int64)
    inv[np.asarray(lane.order)] = np.arange(n)
    np.testing.assert_array_equal(chosen, np.where(fit[inv], inv, -1))
    assert scores.tobytes() == score[inv].astype(np.float64).tobytes()
    assert (chosen >= 0).sum() == (feas[:n] & ports_free[:n]).sum()
