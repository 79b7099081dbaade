"""Placement of the port's arrays over a mesh: the logical-axis rules
(:mod:`repro_torch.parallel.sharding`)."""
