from repro_torch.sim.simulator import SimResult, simulate  # noqa: F401
