"""The cuda-marked tests on a machine that has a card but no jax or cv2.

    python3 -m raw_image_pipeline_tpu_torch.tools.card_tests [PYTEST ARGS]

Run from the root of a checkout; PYTEST ARGS default to tests/. The test
modules compare the port with the JAX package and import both at the top,
while the cuda-marked tests hold each kernel against its plain PyTorch
version and call neither jax nor cv2. So every import of jax, jaxlib or
cv2 is given a stand-in module whose attributes are MagicMocks, and pytest
runs with `-m cuda`: the modules collect, and only the card's tests run.
The cuda-marked tests that read a fixture with cv2.imread (NEEDS_CV2)
cannot run so and are deselected; chip_smoke.py's check_api drives the
same API on the card against the CPU.
"""

from __future__ import annotations

import importlib.abc
import importlib.machinery
import os
import sys
import types
from unittest import mock

STUBBED = ("jax", "jaxlib", "cv2")
NEEDS_CV2 = ("tests/test_torch_api.py::test_api_on_card_equals_cpu",)


class _Stub(types.ModuleType):
    """A module whose every attribute is a MagicMock."""

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        value = mock.MagicMock(name=f"{self.__name__}.{name}")
        setattr(self, name, value)
        return value


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path, target=None):
        if fullname.split(".")[0] in STUBBED:
            return importlib.machinery.ModuleSpec(fullname, self, is_package=True)
        return None

    def create_module(self, spec):
        module = _Stub(spec.name)
        module.__path__ = []
        return module

    def exec_module(self, module):
        pass


def main(argv=None) -> int:
    import pytest

    sys.meta_path.insert(0, _StubFinder())
    sys.path.insert(0, os.getcwd())
    args = list(sys.argv[1:] if argv is None else argv) or ["tests"]
    deselect = [a for nodeid in NEEDS_CV2 for a in ("--deselect", nodeid)]
    return int(pytest.main(["-m", "cuda", "-p", "no:cacheprovider", *deselect, *args]))


if __name__ == "__main__":
    sys.exit(main())
