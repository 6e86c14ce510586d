"""The server's main path: the eval broker and blocked evals
(broker.py), the plan applier with its verify pre-pass and group commit
(plan_apply.py), job admission (admission.py), the scheduler workers
(worker.py) and the Server that wires them (core.py); the telemetry
layer beside them: the metrics registry (telemetry.py), the eval-scoped
tracer (tracing.py) and the quality observatory (quality.py).

``Server`` loads on first use, so the solver's modules can import the
registry and the tracer without loading the server."""


def __getattr__(name):
    if name == "Server":
        from .core import Server
        return Server
    raise AttributeError(name)
