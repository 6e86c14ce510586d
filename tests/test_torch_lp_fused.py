"""The persistent LP kernel's order of operations, modelled on the CPU.

csrc/lp_relax.cu runs the whole anneal as one cooperative launch: per
step a row phase (a block per lane, the row in segments of 16,384 nodes:
each logit computed once, the row max, e = exp(logit - max) stored once,
each 32-node window's sum as one chain in node order, one thread a
window, the tree above the windows over every segment's windows, then
x * pcount = (e / sum) * pcount written once), and a node phase (tiles
of 128 nodes; three threads a node run the load's fma chain over the
lanes in order, 128 lanes of the tile staged at a time, then mu). The
final pass writes X = e / sum.

``fused_order`` is that order in plain PyTorch with the port's CPU
arithmetic (XLA's exp, flush-to-zero, the fma chains); it must equal
lp_relax_plain and the reference's _lp_program bit for bit on X and mu,
on chip_smoke.lp_fuzz_inputs at L 8 / 128 x N 256 / 1,024, with and
without oversubscription, and with rows cut into several segments.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from nomad_tpu.solver import lpq as ref_lpq

from nomad_tpu_torch.solver import lpq
from nomad_tpu_torch.solver.lpq import _exp32, _fma32, _ftz

torch.set_num_threads(1)

SEG, TILE_L = 16384, 128


def _row_phase(V, feas, any_f, ask, mu, temp, seg):
    """e = exp(logit - max) of every (lane, node), each logit computed
    once, and each lane's sum: every segment's windows summed one chain
    a window in node order, then the tree above all the windows."""
    L, N = V.shape
    logit = lpq._logits(V, feas, any_f, ask, mu, temp)
    e = _exp32(_ftz(logit - logit.amax(dim=1, keepdim=True)))
    parts = []
    for s0 in range(0, N, min(seg, N)):
        w = e[:, s0:s0 + min(seg, N)].reshape(L, -1, 32)
        acc = torch.zeros_like(w[..., 0])
        for j in range(32):
            acc = _ftz(acc + w[..., j])
        parts.append(acc)
    return e, lpq._tree_sum(torch.cat(parts, dim=1))


def fused_order(V, feas, ask, pcount, free, active, temps, *, seg=SEG):
    """The persistent kernel's order on the CPU: (X (L, N), mu (N, 3))."""
    L, N = V.shape
    cap = free.clamp_min(1.0)
    any_f = feas.any(dim=1, keepdim=True)
    live = any_f & active[:, None]
    mu = torch.zeros_like(free)
    zero = torch.zeros_like(mu)
    for t in range(temps.shape[0]):
        e, rsum = _row_phase(V, feas, any_f, ask, mu, temps[t], seg)
        x = _ftz(e / rsum[:, None])
        xp = _ftz(torch.where(live, x, torch.zeros_like(x))
                  * pcount[:, None])
        # the node phase: the load's chain over the lanes in order, a
        # tile of TILE_L lanes staged at a time
        load = zero
        for l0 in range(0, L, TILE_L):
            for lane in range(l0, min(L, l0 + TILE_L)):
                load = _fma32(xp[lane][:, None], ask[lane][None, :], load)
        m = _ftz(mu + _ftz(_ftz(_ftz(load - free) * lpq.ETA) / cap))
        mu = torch.where(m > 0, m, zero)
    e, rsum = _row_phase(V, feas, any_f, ask, mu, None, seg)
    X = _ftz(e / rsum[:, None])
    return torch.where(live, X, torch.zeros_like(X)), mu


CASES = [(L, N, over) for L in (8, 128) for N in (256, 1024)
         for over in (False, True)]


@pytest.mark.parametrize("L,N,over", CASES)
def test_fused_order_matches_plain_and_reference(L, N, over):
    """The kernel's order against lp_relax_plain and _lp_program, X and mu
    bit for bit, 48 steps."""
    steps = lpq.lpq_steps()
    inputs = chip_smoke.lp_fuzz_inputs(
        np, np.random.default_rng(L + N + int(over)), L, N, over=over)
    temps = lpq.lp_temperatures(steps)
    args = [torch.from_numpy(a) for a in inputs + (temps,)]
    X, mu = fused_order(*args)
    X_plain, mu_plain = lpq.lp_relax_plain(*args)
    X_ref, mu_ref = ref_lpq._lp_program(L, N, steps)(*inputs)
    for got, want in ((X, X_plain), (mu, mu_plain)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    np.testing.assert_array_equal(X.numpy(), np.asarray(X_ref))
    np.testing.assert_array_equal(mu.numpy(), np.asarray(mu_ref))
    if over:
        assert float(mu.max()) > 0.0


@pytest.mark.parametrize("seg", [256, 64])
def test_fused_order_with_rows_in_segments(seg):
    """Where a row has more than one segment (N > 16,384 on the card;
    here segments of 256 and 64 nodes at N 1,024), every segment's window
    sums feed the one tree in window order: still the plain version's
    bits."""
    inputs = chip_smoke.lp_fuzz_inputs(np, np.random.default_rng(7), 8,
                                       1024, over=True)
    args = [torch.from_numpy(a)
            for a in inputs + (lpq.lp_temperatures(12),)]
    X, mu = fused_order(*args, seg=seg)
    X_plain, mu_plain = lpq.lp_relax_plain(*args)
    assert torch.equal(X.view(torch.int32), X_plain.view(torch.int32))
    assert torch.equal(mu.view(torch.int32), mu_plain.view(torch.int32))
