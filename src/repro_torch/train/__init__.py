"""Step functions of the port: the train step (gradient accumulation,
the optimizer) and the serving steps (prefill and decode with
device-side greedy sampling)."""
