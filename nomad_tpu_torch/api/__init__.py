"""The agent's HTTP API, its Python client, the agent config and the dev
agent (port of nomad_tpu/api/; upstream: command/agent/ and api/)."""
from .http import HttpServer, job_from_json, to_jsonable  # noqa: F401
