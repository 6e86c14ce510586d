"""The port's AllocTable (state/alloc_table.py) held against the JAX
package's on the CPU.

Both tables run through the same seeded operation sequences --
register_node (new nodes and re-registrations with new dynamic port
ranges), upsert, upsert_many, remove, compact and preallocate -- over
allocs built with the reference's mock and carried to the port's structs,
without ports, with ports and with more ports than a row holds. After
every operation the two tables must give equal results for ``pack``
(with and without ports, with and without a port-word seed, in a
shuffled node order with a node the table never saw), ``count_placed``,
``usage_by_node``, ``fold_verify``, ``free_rows``, ``version`` and the
port counters, under both settings of the delta kill switch
(``NOMAD_TPU_PACK_DELTA`` / ``NOMAD_TPU_TORCH_PACK_DELTA``). The same
sequences through both packages' StateStore writes (upsert_allocs,
update_allocs_from_client, update_alloc_desired_transition,
delete_allocs, preallocate_allocs, compact_alloc_table) keep equal
tables too.
"""
import numpy as np
import pytest

from nomad_tpu import mock
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.state.alloc_table import AllocTable as RefAllocTable
from nomad_tpu.structs import AllocatedPortMapping
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch.carry import struct_from_reference
from nomad_tpu_torch.state.store import StateStore
from nomad_tpu_torch.state.alloc_table import MAX_PORTS, PORT_WORDS, \
    AllocTable

N_NODES = 12
N_PAD = 16
JOBS = ("tab-a", "tab-b", "tab-c")
GROUPS = ("web", "db")
STATUSES = ("pending", "running", "complete", "failed", "lost")


@pytest.fixture(params=["1", "0"], ids=["delta", "wholesale"])
def delta(request, monkeypatch):
    monkeypatch.setenv("NOMAD_TPU_PACK_DELTA", request.param)
    monkeypatch.setenv("NOMAD_TPU_TORCH_PACK_DELTA", request.param)
    return request.param


class World:
    """Reference structs made from one seed, and their port copies."""

    def __init__(self, seed: int, ports: str):
        ref_reseed_ids(1000 + seed)
        self.rng = np.random.default_rng(seed)
        self.ports = ports
        self.memo = {}
        self.nodes = []
        self.jobs = {j: mock.job(id=j) for j in JOBS}
        self.live_ids = []

    def carry(self, obj):
        return struct_from_reference(obj, self.memo)

    def node(self):
        n = mock.node()
        self._port_range(n)
        self.nodes.append(n)
        return n

    def _port_range(self, n):
        lo = int(self.rng.integers(20000, 20100))
        n.node_resources.min_dynamic_port = lo
        n.node_resources.max_dynamic_port = lo + int(self.rng.integers(5, 60))

    def reregistered(self, n):
        """A re-registration of ``n`` with a new dynamic port range."""
        self._port_range(n)
        self.memo.pop(id(n), None)
        self.memo.pop(id(n.node_resources), None)
        return n

    def alloc(self, alloc_id=None):
        rng = self.rng
        job = self.jobs[JOBS[int(rng.integers(len(JOBS)))]]
        node = self.nodes[int(rng.integers(len(self.nodes)))]
        a = mock.alloc_for(job, node, index=int(rng.integers(100)))
        if alloc_id is not None:
            a.id = alloc_id
        a.task_group = GROUPS[int(rng.integers(len(GROUPS)))]
        for t in a.allocated_resources.tasks.values():
            t.cpu_shares = int(rng.integers(50, 900))
            t.memory_mb = int(rng.integers(32, 700))
        a.allocated_resources.shared.disk_mb = int(rng.integers(0, 400))
        a.client_status = STATUSES[int(rng.integers(len(STATUSES)))]
        a.desired_status = "stop" if rng.random() < 0.2 else "run"
        if rng.random() < 0.05:
            a.node_id = "never-registered"
        if self.ports != "none" and rng.random() < 0.6:
            lo = node.node_resources.min_dynamic_port
            k = int(rng.integers(1, 4))
            if self.ports == "overflow" and rng.random() < 0.3:
                k = MAX_PORTS + int(rng.integers(1, 3))
            vals = [int(v) for v in rng.integers(lo - 3, lo + 70, size=k)]
            if rng.random() < 0.1:
                vals.append(70000)          # out of range: never folded
            a.allocated_resources.shared.ports = [
                AllocatedPortMapping(label=f"p{i}", value=v)
                for i, v in enumerate(vals)]
        return a

    def existing_or_new(self):
        if self.live_ids and self.rng.random() < 0.4:
            return self.alloc(self.live_ids[
                int(self.rng.integers(len(self.live_ids)))])
        a = self.alloc()
        self.live_ids.append(a.id)
        return a


def pack_inputs(world, table_ref, seeded):
    """A shuffled node order (with an unknown node) as table slots, and
    an optional port-word seed."""
    rng = world.rng
    slots = np.full(N_PAD, -1, dtype=np.int32)
    order = rng.permutation(len(world.nodes))
    for pos, i in enumerate(order[:N_PAD - 1]):
        slots[pos] = table_ref.node_slot_of(world.nodes[i].id)
    seed = None
    if seeded:
        seed = np.zeros((N_PAD, PORT_WORDS), dtype=np.uint32)
        for _ in range(20):
            p = int(rng.integers(20000, 20160))
            seed[int(rng.integers(N_PAD)), p >> 5] |= np.uint32(1 << (p & 31))
    return slots, seed


def assert_same_pack(got, want):
    assert set(got) == set(want)
    for key in want:
        if want[key] is None:
            assert got[key] is None, key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == want[key].dtype, key


def assert_same_tables(world, ref, port):
    assert port.version == ref.version
    assert port.free_rows == ref.free_rows
    assert port.n_rows == ref.n_rows
    assert port.rows_with_ports == ref.rows_with_ports
    assert port.has_port_overflow == ref.has_port_overflow
    for with_ports in (False, True):
        for seeded in (False, True):
            slots, seed = pack_inputs(world, ref, seeded)
            want = ref.pack(N_PAD, slots, with_ports, port_words_seed=seed)
            got = port.pack(N_PAD, slots.copy(), with_ports,
                            port_words_seed=seed)
            assert_same_pack(got, want)
            for job in JOBS:
                for tg in GROUPS:
                    w = ref.count_placed(N_PAD, want["row_slots"],
                                         "default", job, tg)
                    g = port.count_placed(N_PAD, got["row_slots"],
                                          "default", job, tg)
                    for a, b in zip(g, w):
                        np.testing.assert_array_equal(a, b)
    assert port.usage_by_node() == ref.usage_by_node()
    ids = [n.id for n in world.nodes] + ["no-such-node"]
    for a, b in zip(port.fold_verify(ids), ref.fold_verify(ids)):
        np.testing.assert_array_equal(a, b)


def run_sequence(world, ref, port, n_ops):
    """Apply ``n_ops`` seeded operations to both tables, comparing after
    each; returns the operation counts."""
    rng = world.rng
    counts = {}
    for k in range(n_ops):
        r = rng.random()
        if k < 6 or r < 0.08:
            if world.nodes and rng.random() < 0.3:
                n = world.reregistered(
                    world.nodes[int(rng.integers(len(world.nodes)))])
            elif len(world.nodes) < N_NODES:
                n = world.node()
            else:
                continue
            op = "register_node"
            assert port.register_node(world.carry(n)) == \
                ref.register_node(n)
        elif r < 0.40:
            op = "upsert"
            a = world.existing_or_new()
            ref.upsert(a)
            port.upsert(world.carry(a))
        elif r < 0.65:
            op = "upsert_many"
            batch = [world.existing_or_new()
                     for _ in range(int(rng.integers(1, 20)))]
            if rng.random() < 0.2 and len(batch) > 1:
                batch.append(batch[0])      # a repeated id: scalar path
            ref.upsert_many(batch)
            port.upsert_many([world.carry(a) for a in batch])
        elif r < 0.85:
            op = "remove"
            if world.live_ids and rng.random() < 0.9:
                aid = world.live_ids.pop(
                    int(rng.integers(len(world.live_ids))))
            else:
                aid = "no-such-alloc"
            ref.remove(aid)
            port.remove(aid)
        elif r < 0.93:
            op = "compact"
            assert port.compact() == ref.compact()
        else:
            op = "preallocate"
            cap = int(rng.integers(1, 5000))
            ref.preallocate(cap)
            port.preallocate(cap)
            assert port._cap == ref._cap
        counts[op] = counts.get(op, 0) + 1
        counts["overflowed"] = counts.get("overflowed", 0) + \
            ref.has_port_overflow
        assert_same_tables(world, ref, port)
    assert port.fold_parity_mismatch() == ref.fold_parity_mismatch() == 0
    return counts


@pytest.mark.parametrize("ports", ["none", "ports", "overflow"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_sequences_match_reference(delta, ports, seed):
    world = World(seed, ports)
    ref, port = RefAllocTable(initial_capacity=16), \
        AllocTable(initial_capacity=16)
    counts = run_sequence(world, ref, port, 120)
    assert {"register_node", "upsert", "upsert_many", "remove",
            "compact"} <= set(counts)
    # the overflow worlds reach the overflow path (the table refuses to
    # pack ports there); the others never do
    assert bool(counts["overflowed"]) == (ports == "overflow")


def test_overflow_row_clears_on_rewrite(delta):
    """A row that held more ports than a row holds leaves the overflow
    set once rewritten with fewer, in both tables."""
    world = World(5, "none")
    ref, port = RefAllocTable(), AllocTable()
    n = world.node()
    ref.register_node(n)
    port.register_node(world.carry(n))
    a = world.alloc()
    a.node_id = n.id
    a.allocated_resources.shared.ports = [
        AllocatedPortMapping(label=f"p{i}", value=20000 + i)
        for i in range(MAX_PORTS + 2)]
    ref.upsert(a)
    port.upsert(world.carry(a))
    assert port.has_port_overflow and ref.has_port_overflow
    a.allocated_resources.shared.ports = a.allocated_resources.shared.ports[:2]
    world.memo.clear()
    ref.upsert(a)
    port.upsert(world.carry(a))
    assert not port.has_port_overflow and not ref.has_port_overflow
    assert_same_tables(world, ref, port)


@pytest.mark.parametrize("seed", [3, 4])
def test_store_writes_keep_equal_tables(delta, seed):
    """Both packages' StateStores through the same writes: the tables
    stay equal, a compaction happens once enough rows are free, and the
    journal's index moves alike."""
    world = World(seed, "ports")
    ref, port = RefStateStore(), StateStore()
    for _ in range(N_NODES):
        n = world.node()
        ref.upsert_node(n)
        port.upsert_node(world.carry(n))
    ref.preallocate_allocs(3000)
    port.preallocate_allocs(3000)
    assert port.alloc_table._cap == ref.alloc_table._cap
    rng = world.rng
    compactions = 0
    for step in range(40):
        # writes first, then a drain that frees rows faster than the
        # writes reuse them
        n_new = int(rng.integers(8, 30)) if step < 25 else 4
        batch = [world.alloc() for _ in range(n_new)]
        world.live_ids.extend(a.id for a in batch)
        ref.upsert_allocs(batch)
        port.upsert_allocs([world.carry(a) for a in batch])
        ids = list(world.live_ids)
        picks = [ids[int(i)] for i in rng.choice(len(ids), size=6,
                                                  replace=False)]
        ups = []
        for aid in picks[:3]:
            stored = ref.alloc_by_id(aid)
            u = stored.copy_skip_job() if hasattr(stored, "copy_skip_job") \
                else stored
            u.client_status = "complete"
            ups.append(u)
        ref.update_allocs_from_client(ups)
        port.update_allocs_from_client([world.carry(u) for u in ups])
        ref.update_alloc_desired_transition(picks[3:4])
        port.update_alloc_desired_transition(picks[3:4])
        gone = [world.live_ids.pop(int(rng.integers(len(world.live_ids))))
                for _ in range(int(rng.integers(5, 25)))
                if len(world.live_ids) > 6]
        ref.delete_allocs(gone)
        port.delete_allocs(gone)
        want = ref.compact_alloc_table(min_free=40, free_ratio=0.3)
        got = port.compact_alloc_table(min_free=40, free_ratio=0.3)
        assert got == want
        compactions += want is not None
        assert port.latest_index() == ref.latest_index()
        assert port.quality_usage_by_node() == ref.quality_usage_by_node()
        assert_same_tables(world, ref.alloc_table, port.alloc_table)
    assert compactions >= 1
    assert port.alloc_table.fold_parity_mismatch() == 0
