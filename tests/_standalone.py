"""Per-file standalone test entry points.

The reference runs every test file standalone via a ``main()`` printing a
per-test summary (test_module_a.py:358-377) in addition to the pytest
wrapper. Here the dual entry point delegates to pytest itself (fixtures,
parametrize and the conftest CPU-mesh setup keep working), with verbose
per-test lines and the summary table pytest prints at the end:

    python tests/test_solvers.py           # run one backend's suite
    python tests/test_solvers.py -k cg     # extra pytest args pass through
"""

import os
import sys


def run_standalone(path: str) -> None:
    # conftest.py sets the same default; set it here too so backend init
    # between module import and pytest startup stays on CPU
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import pytest

    raise SystemExit(pytest.main([path, "-v", "--tb=short"]
                                 + sys.argv[1:]))
