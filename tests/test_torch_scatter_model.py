"""A numpy model of the delta scatter kernel's partition
(nomad_tpu_torch/csrc/delta_scatter.cu, scatter_local and
scatter_persistent) against the plain version and the JAX program it
replaces, on the CPU.

The kernel is one launch. The table is cut into chunks of kThreads x
kInFlight units (16-byte words when the base and the output are both
16-byte aligned, the tail past the last whole word element by element
with the last chunk; else elements); a thread issues its kInFlight loads
of a chunk before their stores. With few updates (the other blocks'
reads of all k indices at most a kLocalShare-th of the table's bytes) a
block per chunk copies it and writes the updates landing in it; else a
cooperative grid copies the chunks, syncs once and writes the updates
grid-stride. Indices outside [0, M) are dropped. The model runs that
schedule over the bytes of a table, counts how often each word and
element is written, checks that the chunks' element ranges partition the
table, and must give delta_scatter_plain's bytes and
nomad_tpu/solver/constcache.py _delta_scatter_program's, with word,
tail and chunk edges, unaligned starts, out-of-range and negative
indices, padded duplicates, a diff of 25% of the table, every element
size and -0.0 / NaN payloads.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nomad_tpu.solver import constcache

from nomad_tpu_torch.solver import resident

SRC = (Path(__file__).resolve().parents[1] / "nomad_tpu_torch" / "csrc"
       / "delta_scatter.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, IN_FLIGHT, BLOCKS_PER_SM, LOCAL_SHARE = (
    _const("kThreads"), _const("kInFlight"), _const("kBlocksPerSm"),
    _const("kLocalShare"))
CHUNK = THREADS * IN_FLIGHT
H100_SMS = 132


def launcher(m, s, k, aligned, sms=H100_SMS, per_sm=8):
    """The launcher's choice (delta_scatter.cu launch): (form, blocks,
    chunks)."""
    units = m * s // 16 if aligned else m
    nchunks = -(-units // CHUNK) if units > 0 else 1
    if 4 * k * (nchunks - 1) * LOCAL_SHARE <= m * s:
        return "local", nchunks, nchunks
    blocks = max(nchunks, -(-k // THREADS))
    return "coop", min(blocks, sms * min(per_sm, BLOCKS_PER_SM)), nchunks


def model_scatter(src, idx, vals, *, aligned, sms=H100_SMS, per_sm=8,
                  form=None):
    """The kernel's schedule over numpy arrays, in the launcher's form
    or the one named (either is right for any input): returns (out,
    form)."""
    m, s = src.size, src.dtype.itemsize
    k = idx.size
    picked, blocks, nchunks = launcher(m, s, k, aligned, sms, per_sm)
    if form == "coop" and picked == "local":
        blocks = min(max(nchunks, -(-k // THREADS)),
                     sms * min(per_sm, BLOCKS_PER_SM))
    form = form or picked
    per = 16 // s if aligned else 1
    units = m // per
    out = np.zeros_like(src)
    ob, sb = out.view(np.uint8), src.view(np.uint8)
    unit = 16 if aligned else s
    ou = ob[:units * unit].reshape(-1, unit)
    su = sb[:units * unit].reshape(-1, unit)
    copies = np.zeros(m, dtype=np.int64)
    ranges = []
    for b in range(nchunks):       # coop: block b % blocks copies chunk b
        lo, hi = b * CHUNK, min((b + 1) * CHUNK, units)
        for base in range(lo, hi, IN_FLIGHT * THREADS):
            # kInFlight loads a thread, then their stores
            for j in range(IN_FLIGHT):
                i = base + j * THREADS + np.arange(THREADS)
                i = i[i < hi]
                ou[i] = su[i]
                for p in range(per):
                    copies[i * per + p] += 1
        elo, ehi = lo * per, hi * per
        if b == nchunks - 1:        # the tail past the last whole word
            out[ehi:] = src[ehi:]
            copies[ehi:] += 1
            ehi = m
        ranges.append((elo, ehi))
    assert (copies == 1).all()
    assert ranges[0][0] == 0 and ranges[-1][1] == m and all(
        a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    j = idx.astype(np.int64)
    if form == "local":
        # each block: every update landing in its element range
        for elo, ehi in ranges:
            hit = (j >= elo) & (j < ehi)
            out[j[hit]] = vals[hit]
    else:
        # grid.sync(); the updates grid-stride, out-of-range dropped
        stride = blocks * THREADS
        u = np.arange(stride)
        while (u < k).any():
            v = u[u < k]
            keep = (j[v] >= 0) & (j[v] < m)
            out[j[v][keep]] = vals[v[keep]]
            u = u + stride
    return out, form


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and (a.reshape(-1).view(np.uint8)
                 == b.reshape(-1).view(np.uint8)).all())


def table(dtype, m, rng):
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(m) < 0.5
    if dt.kind == "f":
        a = rng.standard_normal(m).astype(dt)
        bits = a.view(np.dtype("u%d" % dt.itemsize))
        nan = np.array([np.nan], dtype=dt).view(bits.dtype)[0]
        a[:min(m, 3)] = np.array([-0.0, np.inf, -np.inf], dtype=dt)[:m]
        bits[3:5] = [nan | 1, nan | 5][:max(0, min(m, 5) - 3)]
        return a
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, m, dtype=dt, endpoint=True)


def edge_indices(m, s, stride_elems):
    """Indices on 16-byte word edges, the tail's first element, one
    grid stride's edges, and the table's ends."""
    per_word = 16 // s
    cand = {0, m - 1, m * s // 16 * per_word}
    for w in (1, 2, 7):
        cand |= {w * per_word - 1, w * per_word}
    cand |= {stride_elems - 1, stride_elems, IN_FLIGHT * stride_elems}
    return np.array(sorted(c for c in cand if 0 <= c < m), dtype=np.int64)


DTYPES = ("bool", "uint8", "float16", "int16", "float32", "int32",
          "float64", "int64")


def _plain(buf, idx_p, vals_p):
    return resident.delta_scatter_plain(
        torch.from_numpy(buf.copy()), torch.from_numpy(idx_p),
        torch.from_numpy(vals_p)).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n_upd", [(5, 3), (4 + 16 * 33, 20),
                                     (65_536 + 3, 300), (4096, 1024)])
def test_model_matches_plain_and_reference(dtype, m, n_upd):
    """Aligned tables with and without a tail, tables below one word,
    updates on word, tail and stride edges plus random ones, padded to
    their bucket with slot 0's duplicates (1024 of 4096: a 25% diff)."""
    rng = np.random.default_rng(m + n_upd)
    buf = table(dtype, m, rng)
    s = buf.dtype.itemsize
    edges = edge_indices(m, s, CHUNK * 16 // s)
    rest = rng.choice(np.setdiff1d(np.arange(m), edges),
                      max(0, n_upd - edges.size), replace=False)
    idx = np.concatenate([edges, rest])[:n_upd]
    idx_p, vals_p, bucket = resident._pad_updates(
        idx, table(dtype, idx.size, rng))
    want = _plain(buf, idx_p, vals_p)
    prog = constcache._delta_scatter_program((m,), buf.dtype.str, bucket)
    assert same_bytes(want, np.asarray(prog(buf, idx_p, vals_p)))
    for form in ("local", "coop"):
        got, _ = model_scatter(buf, idx_p, vals_p, aligned=True, form=form)
        assert same_bytes(got, want), form


@pytest.mark.parametrize("dtype", ("bool", "float16", "float32",
                                   "float64"))
@pytest.mark.parametrize("sms,per_sm", [(1, 1), (3, 1), (132, 8)])
def test_unaligned_start_runs_element_by_element(dtype, sms, per_sm):
    """A table that starts one element into its buffer is cut into
    chunks of elements; in the cooperative form small grids walk the
    chunks and the updates in many strides."""
    rng = np.random.default_rng(7)
    whole = table(dtype, 3 * 4096 + 1, rng)
    buf = whole[1:]
    assert buf.ctypes.data % 16 != 0
    idx = rng.choice(buf.size, 200, replace=False)
    idx_p, vals_p, bucket = resident._pad_updates(idx,
                                                  table(dtype, 200, rng))
    want = _plain(buf, idx_p, vals_p)
    prog = constcache._delta_scatter_program((buf.size,), buf.dtype.str,
                                             bucket)
    assert same_bytes(want, np.asarray(prog(buf, idx_p, vals_p)))
    for form in ("local", "coop"):
        got, _ = model_scatter(buf, idx_p, vals_p, aligned=False, sms=sms,
                               per_sm=per_sm, form=form)
        assert same_bytes(got, want), form


@pytest.mark.parametrize("form", ("local", "coop"))
@pytest.mark.parametrize("dtype", ("uint8", "int16", "float32", "float64"))
def test_out_of_range_and_negative_indices_are_dropped(dtype, form):
    """Indices at M, past it and below 0 write nothing, in both forms and
    in the plain version (the reference's own padding never makes them;
    JAX would wrap a negative one, so only the port's two are held)."""
    rng = np.random.default_rng(11)
    m = 5000
    buf = table(dtype, m, rng)
    idx = np.array([m, m + 1, 2 ** 31 - 1, -1, -(2 ** 31), 5, 999, 0, 16],
                   dtype=np.int32)
    vals = table(dtype, idx.size, rng)
    got, _ = model_scatter(buf, idx, vals, aligned=True, sms=2, per_sm=1,
                           form=form)
    want = _plain(buf, idx, vals)
    assert same_bytes(got, want)
    keep = got.copy()
    keep[[5, 999, 0, 16]] = buf[[5, 999, 0, 16]]
    assert same_bytes(keep, buf)


@pytest.mark.parametrize("shape,aligned,form", [
    ((1_572_864, 4, 256), True, "local"),       # the residency path's g3
    ((1_572_864, 1, 256), True, "local"),       # g3's shape in bool
    ((1_572_864, 4, 256), False, "local"),      # g3 from an unaligned view
    ((1_572_864, 4, 393_216), True, "coop"),    # a diff of 25% of M
    ((16, 4, 8), True, "local"),                # the launch floor's shape
    ((4096, 8, 4096), True, "coop")])
def test_launcher_picks_the_form(shape, aligned, form):
    m, s, k = shape
    picked, blocks, nchunks = launcher(m, s, k, aligned)
    assert picked == form
    if form == "coop":
        assert blocks <= H100_SMS * BLOCKS_PER_SM
    else:
        assert blocks == nchunks


def test_g3_promotion_through_the_model():
    """At g3's shape (M 1,572,864 float32, k 256, block-local) the model
    gives the plain version's bytes."""
    rng = np.random.default_rng(3)
    m, k = 1_572_864, 256
    buf = table("float32", m, rng)
    idx = rng.choice(m, 150, replace=False)
    idx_p, vals_p, bucket = resident._pad_updates(
        idx, table("float32", 150, rng))
    assert bucket == k
    got, form = model_scatter(buf, idx_p, vals_p, aligned=True)
    assert form == "local"
    assert same_bytes(got, _plain(buf, idx_p, vals_p))


@pytest.mark.parametrize("dtype", ("bool", "float16", "float32", "float64",
                                   "int64"))
def test_one_buffer_payload_decodes_to_idx_and_vals(dtype):
    """_scatter_single's staging buffer: the int32 indices, then the
    values from the next 16-byte boundary, bit for bit."""
    rng = np.random.default_rng(5)
    for n in (1, 3, 8, 13, 256):
        idx_p = rng.integers(0, 10_000, n).astype(np.int32)
        vals_p = table(dtype, n, rng)
        host, off = resident._stage_payload(idx_p, vals_p, pinned=False)
        assert off % 16 == 0 and off >= 4 * n > off - 16
        assert host.dtype == torch.uint8 and host.numel() == off + \
            vals_p.nbytes
        assert same_bytes(host[:4 * n].view(torch.int32).numpy(), idx_p)
        t = torch.from_numpy(vals_p[:0]).dtype
        assert same_bytes(host[off:].view(t).numpy(), vals_p)
