"""The benchmark's own CPU tests (``python -m pytest gpubench/tests`` from
the root of the checkout)."""

import pytest

from gpubench_helpers import smoke_port_fixture


@pytest.fixture
def smoke_port(monkeypatch):
    """The port's configs at their SMOKE sizes; ``smoke_port(**fields)``
    replaces fields of them."""
    return smoke_port_fixture(monkeypatch)
