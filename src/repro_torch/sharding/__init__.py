"""The parallel layer: partition rules (``specs``), the model code's
sharding context (``ctx``) and the counted collectives (``comm``)."""
