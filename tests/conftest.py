import os

# Tests run on the CPU with a virtual 8-device mesh for the sharding checks;
# the GPU path is exercised by chip_smoke.py.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
