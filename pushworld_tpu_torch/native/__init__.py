from pushworld_tpu_torch.native.bridge import is_available, solve_native  # noqa: F401
