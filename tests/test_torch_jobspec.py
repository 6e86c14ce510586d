"""The port's jobspec (nomad_tpu_torch/jobspec/) and struct codec
(nomad_tpu_torch/structs/codec.py) held against the JAX package's on
the CPU.

Tolerance: exact. Every HCL spec of tests/test_jobspec_cli.py, and a
spec with the blocks those leave out (device, periodic, parameterized,
volume, migrate, connect, artifact, vault, scaling, constraint sugar),
is parsed by both packages: the port's Job equals the reference's
carried Job (``carry.struct_from_reference``) field by field, and the
specs that fail fail with the same error text. The codec's encoded
Node, Allocation and Job equal the reference's encoded dicts, and decode
back to the struct they came from.
"""
import itertools
from typing import List

import pytest

from nomad_tpu import mock
from nomad_tpu.jobspec import HclError as RefHclError
from nomad_tpu.jobspec import duration as ref_duration
from nomad_tpu.jobspec import parse as ref_parse
from nomad_tpu.structs import codec as ref_codec
from nomad_tpu.structs.job import reseed_ids as ref_reseed_ids

from nomad_tpu_torch import mock as pmock
from nomad_tpu_torch import structs as pst
from nomad_tpu_torch.carry import struct_from_reference
from nomad_tpu_torch.jobspec import HclError, duration, parse, parse_file
from nomad_tpu_torch.structs import codec

from test_jobspec_cli import MINI_SPEC, SPEC

FN_SPEC = """
variable "env" { default = "prod" }
variable "dcs" { default = ["dc1"] }
job "fn-job" {
  datacenters = concat(var.dcs, ["dc2"])
  meta {
    env_u    = upper(var.env)
    banner   = format("svc-%s-%d", var.env, 3)
    joined   = join(",", ["a", "b", "c"])
    short    = substr("abcdefgh", 2, 3)
    via_tpl  = "name=${upper(var.env)}"
    runtime  = "${NOMAD_TASK_DIR}/x"
  }
  group "g" {
    count = max(2, length(var.dcs))
    task "t" {
      driver = "mock"
      resources { cpu = 100 memory = 64 }
    }
  }
}
"""

RUNTIME_REF_SPEC = ('job "x" {\n'
                    '  meta { v = "${upper(NOMAD_ALLOC_ID)}" '
                    'ok = "${upper("abc")}" }\n'
                    '  group "g" { task "t" { driver = "mock" } }\n'
                    '}')

TYPED_SPEC = """
variable "count" {
  type    = number
  default = 2
}
variable "image" {
  type = string
}
variable "dcs" {
  type    = list(string)
  default = ["dc1"]
}
job "t" {
  datacenters = var.dcs
  group "g" {
    count = var.count
    task "w" {
      driver = "mock"
      config { image = var.image }
    }
  }
}
"""

# the blocks the specs above leave out
EXTRA_SPEC = """
locals {
  tier = "gold"
}
job "extra" {
  type      = "batch"
  region    = "east"
  namespace = "default"
  node_pool = "default"
  all_at_once = true
  periodic {
    cron             = "@every 30s"
    prohibit_overlap = true
    time_zone        = "UTC"
  }
  parameterized {
    payload       = "required"
    meta_required = ["a"]
    meta_optional = ["b", "c"]
  }
  affinity {
    attribute = "${node.class}"
    value     = "${local.tier}"
    weight    = -30
  }
  constraint {
    distinct_hosts = true
  }
  constraint {
    attribute = "${meta.rack}"
    regexp    = "r[0-9]+"
  }
  group "gpu" {
    count = 2
    max_client_disconnect = "2m"
    scaling {
      min = 1
      max = 4
      policy "cpu" { target = 70 }
    }
    migrate {
      max_parallel     = 2
      min_healthy_time = "15s"
    }
    volume "data" {
      type      = "host"
      source    = "shared"
      read_only = true
      per_alloc = true
    }
    service {
      name = "api"
      port = "http"
      tags = ["a", "b"]
      check { type = "http" path = "/health" }
      connect {
        sidecar_service {
          proxy {
            upstreams {
              destination_name = "db"
              local_bind_port  = 5432
            }
          }
        }
      }
    }
    task "train" {
      driver      = "mock"
      kill_timeout = "20s"
      artifact {
        source      = "https://example.com/x.tgz"
        destination = "local/"
      }
      vault { policies = ["p"] }
      resources {
        cpu    = 1000
        memory = 1024
        cores  = 2
        device "nvidia/gpu" {
          count = 2
          constraint {
            attribute = "${device.attr.memory_mib}"
            operator  = ">="
            value     = "40000"
          }
          affinity {
            attribute = "${device.model}"
            value     = "H100"
            weight    = 50
          }
        }
      }
    }
  }
}
"""

# (spec, variables): every spec that parses
GOOD = {
    "full": (SPEC, None),
    "full-override": (SPEC, {"image_tag": "v2-override"}),
    "mini": (MINI_SPEC, None),
    "functions": (FN_SPEC, None),
    "runtime-ref": (RUNTIME_REF_SPEC, None),
    "typed": (TYPED_SPEC, {"image": "app:v1", "count": "7",
                           "dcs": "dc1,dc2"}),
    "extra": (EXTRA_SPEC, None),
}

# every spec that fails, with its variables
BAD = {
    "unterminated": ("job web {", None),
    "no-job": ('group "g" {}', None),
    "missing-var": ('job "x" { meta = ${var.missing} }', None),
    "unknown-fn": ('job "x" { datacenters = bogus_fn("a") \n'
                   ' group "g" { task "t" { driver = "mock" } } }', None),
    "required-var": (TYPED_SPEC, {}),
    "bad-type": (TYPED_SPEC, {"image": "x", "count": "notnum"}),
}


def _carried(ref_job):
    return struct_from_reference(ref_job)


@pytest.mark.parametrize("name", sorted(GOOD))
def test_spec_parses_to_the_reference_job(name):
    src, variables = GOOD[name]
    got = parse(src, variables)
    want = _carried(ref_parse(src, variables))
    assert got == want


def test_extra_spec_keeps_its_blocks():
    job = parse(EXTRA_SPEC)
    assert isinstance(job.periodic, pst.PeriodicConfig)
    assert job.periodic.spec == "@every 30s"
    assert isinstance(job.parameterized, pst.ParameterizedJobConfig)
    assert job.parameterized.meta_optional == ["b", "c"]
    assert job.affinities[0].r_target == "gold"
    dev = job.task_groups[0].tasks[0].resources.devices[0]
    assert (dev.name, dev.count) == ("nvidia/gpu", 2)
    assert dev.constraints[0].operand == ">="


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_spec_fails_as_the_reference_does(name):
    src, variables = BAD[name]
    with pytest.raises(RefHclError) as want:
        ref_parse(src, variables)
    with pytest.raises(HclError) as got:
        parse(src, variables)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("val,default", [
    ("30s", 0.0), ("5m", 0.0), ("1h30m", 0.0), ("250ms", 0.0), ("2d", 0.0),
    (42, 0.0), (None, 7.0), ("", 3.0), ("1.5", 0.0)])
def test_duration_matches_the_reference(val, default):
    assert duration(val, default) == ref_duration(val, default)


def test_parse_file(tmp_path):
    path = tmp_path / "mini.nomad"
    path.write_text(MINI_SPEC)
    assert parse_file(str(path)) == _carried(ref_parse(MINI_SPEC))


# -- the codec ----------------------------------------------------------------

def _ref_structs():
    ref_reseed_ids(7)
    mock._counter = itertools.count()
    node = mock.gpu_node(count=2)
    node.meta["rack"] = "r1"
    job = mock.job()
    job.task_groups[0].count = 3
    alloc = mock.alloc_for(job, node, 1)
    return {"node": node, "alloc": alloc, "job": job}


@pytest.mark.parametrize("kind,cls", [("node", pst.Node),
                                      ("alloc", pst.Allocation),
                                      ("job", pst.Job)])
def test_codec_round_trip_equals_the_reference(kind, cls):
    ref = _ref_structs()[kind]
    port = _carried(ref)
    enc = codec.encode(port)
    assert enc == ref_codec.encode(ref)
    back = codec.decode(cls, enc)
    assert back == port
    assert codec.encode(back) == enc


def test_codec_decodes_a_list_of_allocs():
    ref = _ref_structs()
    allocs = [_carried(ref["alloc"])]
    enc = [codec.encode(a) for a in allocs]
    assert codec.decode(List[pst.Allocation], enc) == allocs


def test_port_mock_encodes_as_the_reference_mock():
    """mock.node() on both sides, ids seeded alike: one wire form."""
    for seed in (1, 2):
        ref_reseed_ids(seed)
        pst.reseed_ids(seed)
        mock._counter = itertools.count()
        pmock._counter = itertools.count()
        assert codec.encode(pmock.node()) == ref_codec.encode(mock.node())
