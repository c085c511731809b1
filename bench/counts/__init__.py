"""Frozen counts of the work one decode step needs, a module a family:
``step(config, batch, pos) -> (flops, bytes)``, from the configuration's
shapes alone, so they read the same whatever implements the step. Bytes
count each weight read once, the state or cache rows a step must read once
and what it writes once; activations between layers are left out."""
