"""The JAX package's examples, run through the port:
``python -m repro_torch.examples.<name>`` (add ``--device cpu`` without a
GPU).  Each module's ``main(argv=None)`` keeps its reference example's
workload and printed lines."""
