"""The node agent's ported half (port of nomad_tpu/client/; upstream:
client/): the simulated client with the mock driver, and fingerprinting
with the CUDA cards."""
from .agent import SimClient  # noqa: F401
from .fingerprint import FingerprintManager  # noqa: F401
