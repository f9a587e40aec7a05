"""Named workloads: the reference's problem configurations and the config ladder."""
