from repro_torch.memory.block_manager import BlockManager  # noqa: F401
