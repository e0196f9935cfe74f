"""Shared by the port's test modules (``tests/test_torch_*.py``): the JAX
package's oracles compiled without XLA's optimization passes.

The oracles are small programs traced once and run a few times, where
XLA's optimization passes cost more than they save (the port's test files
together take about a fifth less time). A module imports
``unoptimized_reference`` (an autouse, module-scoped fixture) and its JAX
calls compile with ``jax_disable_most_optimizations``; at the module's end
the flag is restored and JAX's caches are cleared, so no executable
compiled this way serves a later module (the flag is not part of JAX's
cache key). Nothing is loosened: every tolerance stays as it was.
"""
import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def unoptimized_reference():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)
    jax.clear_caches()
