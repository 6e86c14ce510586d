"""The host scheduler (port of nomad_tpu/scheduler/; upstream:
scheduler/): the reconciler, the stacks and their iterators, the generic
and system schedulers, the factory and the harness."""
