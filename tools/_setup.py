"""Shared start-up for the measurement tools."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def device(cpu: bool):
    """The device a tool measures on. --cpu runs on the host CPU (a
    rehearsal: its times are no device metric); otherwise anything but a
    GPU is refused. Turns on the persistent compile cache."""
    import jax
    from gpismap.runtime.compile_cache import enable_compile_cache

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not cpu:
        sys.exit(f"{os.path.basename(sys.argv[0])}: needs a GPU, JAX found "
                 f"{dev.platform} (pass --cpu for a CPU rehearsal)")
    enable_compile_cache()
    return dev
