"""The job specification language (port of nomad_tpu/jobspec/; upstream:
jobspec2/): HCL text to a Job struct."""
from .hcl import Block, HclError, parse_hcl  # noqa: F401
from .parse import duration, parse, parse_file  # noqa: F401
