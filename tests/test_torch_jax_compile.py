"""Compile the JAX reference with most of XLA's optimisation passes off.

The port's CPU tests run the JAX package as the reference; in several of
them the JAX side's time is XLA compiling large programs (a train step's
gradient through two adaptive weights, an ae step with LPIPS), each run
once.  ``jax_disable_most_optimizations`` skips most of the passes that
make the compiled program fast; the reference computes the same function,
its values moving at most by float32 rounding (measured: the vf test's
gradient 1.46e-6 and 1.49e-6 relative L2 from the port's, with and without).

A test module imports ``light_xla_compile`` (an autouse, module-scoped
fixture) as it imports ``one_torch_thread``; the setting is restored after
the module, so that the JAX package's own tests in the same worker compile
as before.
"""

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def light_xla_compile():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def test_a_module_compiles_jax_with_light_xla():
    assert jax.config.read("jax_disable_most_optimizations") is True
