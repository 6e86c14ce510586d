"""The server's main path: the eval broker and blocked evals
(broker.py), the plan applier with its verify pre-pass and group commit
(plan_apply.py), job admission (admission.py), the scheduler workers
(worker.py) and the Server that wires them (core.py)."""
from .core import Server  # noqa: F401
