"""The port's native service catalog (client/serviceregistration.py,
SimClient's registrations, the store's service table and the Server's
upsert_services / service_names and its cleanups) held against the JAX
package's on the CPU: both packages' node agents start the same allocs
(the port's carried from the reference's world), and the catalog is
compared, registration for registration with its indexes, after the
starts, after a node goes down and after allocs turn terminal. Exact.
"""
import dataclasses
import itertools
import time

import pytest

from nomad_tpu import mock
from nomad_tpu.client.agent import SimClient as RefSimClient
from nomad_tpu.client.serviceregistration import (
    build_registrations as ref_build)
from nomad_tpu.server import Server as RefServer
from nomad_tpu.state import StateStore as RefStateStore
from nomad_tpu.structs import (
    AllocatedPortMapping, Allocation, NetworkResource, Port, Service)
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch.carry import store_from_reference, struct_from_reference
from nomad_tpu_torch.client import SimClient
from nomad_tpu_torch.client.serviceregistration import build_registrations
from nomad_tpu_torch.server import Server

NOW = 1_700_000_000.0


def service_job(job_id, namespace="default"):
    """A job whose group carries a nomad service on its "http" port and
    a consul one, and whose task carries a nomad service with no port."""
    j = mock.job(id=job_id)
    j.namespace = namespace
    tg = j.task_groups[0]
    tg.count = 2
    tg.networks = [NetworkResource(dynamic_ports=[Port(label="http")])]
    tg.services = [Service(name=f"{job_id}-web", port_label="http",
                           provider="nomad", tags=["web", "v1"]),
                   Service(name=f"{job_id}-consul", provider="consul")]
    tg.tasks[0].services = [Service(name=f"{job_id}-task",
                                    provider="nomad", tags=["v1", "t"])]
    return j


@pytest.fixture
def world(monkeypatch):
    """(reference Server, port Server, their nodes): three nodes (one
    with an address attribute), two service jobs (default and team-a)
    and a plain one, their allocs pending on the nodes."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    ref_reseed_ids(29)
    mock._counter = itertools.count()
    store = RefStateStore()
    nodes = [mock.node() for _ in range(3)]
    nodes[0].attributes["unique.network.ip-address"] = "10.0.0.7"
    for n in nodes:
        store.upsert_node(n)
    from nomad_tpu.structs import Namespace
    store.upsert_namespace(Namespace(name="team-a"))
    allocs = []
    for k, j in enumerate((service_job("svc"), service_job("api", "team-a"),
                           mock.job(id="plain"))):
        store.upsert_job(j)
        for i in range(2):
            a = mock.alloc_for(j, nodes[(k + i) % 3], i)
            a.namespace = j.namespace
            a.allocated_resources.shared.ports = [
                AllocatedPortMapping(label="http", value=20000 + 10 * k + i)]
            allocs.append(a)
    store.upsert_allocs(allocs)
    ref = RefServer(state=store)
    port = Server(state=store_from_reference(store.snapshot()),
                  device="cpu")
    return ref, port, nodes


def catalog(server):
    st = server.state
    return {"regs": [dataclasses.asdict(r)
                     for r in st.service_registrations()],
            "names": server.service_names(),
            "team": server.service_names("team-a"),
            "index": st.latest_index(),
            "services_index": st.table_index("services")}


def same(ref, port):
    got, want = catalog(port), catalog(ref)
    assert got == want
    return got


def start_clients(ref, port, nodes):
    for node in nodes:
        RefSimClient(ref, node)._reconcile_allocs()
        SimClient(port, port.state.node_by_id(node.id))._reconcile_allocs()


def test_build_registrations_equals_the_reference(world):
    ref, port, nodes = world
    memo = {}
    n = 0
    for a in ref.state.allocs():
        node = ref.state.node_by_id(a.node_id)
        got = build_registrations(struct_from_reference(a, memo),
                                  struct_from_reference(node, memo))
        want = ref_build(a, node)
        assert [dataclasses.asdict(r) for r in got] == \
            [dataclasses.asdict(r) for r in want]
        n += len(got)
    assert n == 8           # two nomad services an alloc of the two jobs
    assert ref_build(Allocation(id="x"), nodes[0]) == []


def test_catalog_after_starts_node_down_and_terminal_allocs(world):
    ref, port, nodes = world
    assert same(ref, port)["regs"] == []
    start_clients(ref, port, nodes)
    got = same(ref, port)
    assert len(got["regs"]) == 8
    assert {r["address"] for r in got["regs"]} == {"10.0.0.7",
                                                   "127.0.0.1"}
    assert sorted(r["port"] for r in got["regs"]) == \
        [0, 0, 0, 0, 20000, 20001, 20010, 20011]
    # starting again registers nothing new: every alloc runs
    start_clients(ref, port, nodes)
    same(ref, port)
    # a node down: its registrations leave in one write
    for srv in (ref, port):
        srv.update_node_status(nodes[1].id, "down")
    got = same(ref, port)
    assert len(got["regs"]) == 4
    assert nodes[1].id not in {r["node_id"] for r in got["regs"]}
    # a node down without registrations writes nothing to the table
    for srv in (ref, port):
        srv.update_node_status(nodes[1].id, "ready")
        srv.update_node_status(nodes[1].id, "down")
    same(ref, port)
    # allocs turning terminal: their registrations leave in one write
    done = [a for a in ref.state.allocs()
            if a.node_id == nodes[0].id and a.job_id == "svc"]
    assert done
    for srv, carry in ((ref, lambda a: a), (port, struct_from_reference)):
        upd = []
        for a in done:
            u = Allocation(id=a.id, namespace=a.namespace,
                           node_id=a.node_id, job_id=a.job_id,
                           task_group=a.task_group)
            u.client_status = "complete"
            upd.append(carry(u))
        srv.update_allocs_from_client(upd)
    got = same(ref, port)
    assert not {a.id for a in done} & {r["alloc_id"] for r in got["regs"]}
    assert len(got["regs"]) == 2


def test_upsert_services_and_deletes_equal_the_reference(world):
    ref, port, nodes = world
    start_clients(ref, port, nodes)
    regs = ref.state.service_registrations()
    extra = [dataclasses.replace(regs[0], id="manual-1"),
             dataclasses.replace(regs[0], id="manual-2", provider="consul"),
             dataclasses.replace(regs[0], id="manual-3", service_name="")]
    for srv, carry in ((ref, lambda r: r), (port, struct_from_reference)):
        srv.upsert_services([carry(r) for r in extra])
        srv.upsert_services([])
    got = same(ref, port)
    assert "manual-1" in {r["id"] for r in got["regs"]}
    assert not {"manual-2", "manual-3"} & {r["id"] for r in got["regs"]}
    for srv in (ref, port):
        st = srv.state
        st.delete_service_registrations(["manual-1", "nope"])
        st.delete_services_by_alloc(regs[1].alloc_id)
        st.delete_services_by_allocs(["nope"])
        st.delete_services_by_node("nope")
    same(ref, port)
    for srv in (ref, port):
        name = regs[2].service_name
        assert [r.id for r in srv.state.services_by_name(
            regs[2].namespace, name)] == \
            sorted(r.id for r in srv.state.service_registrations()
                   if r.service_name == name
                   and r.namespace == regs[2].namespace)
