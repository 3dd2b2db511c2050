"""The benchmark's CPU tests: the program on the path, and one scratch
checkout with the small cells of :mod:`portbench.smoke` for each test
process."""
import sys

import pytest

from portbench.harness import ROOT

if str(ROOT / "src_torch") not in sys.path:
    sys.path.insert(0, str(ROOT / "src_torch"))


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    from portbench import smoke

    return smoke.make_root(tmp_path_factory.mktemp("portbench"))
