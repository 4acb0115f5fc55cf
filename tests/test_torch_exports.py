"""The port's packages export what the JAX package's export: for every
``k_llms_tpu`` package with an ``__all__``, the ``k_llms_tpu_torch``
package of the same name has the same ``__all__``, and each of its names
imports from it (``from k_llms_tpu_torch.reliability import RetryPolicy``
works where the JAX import does). ``ReplicaSet`` stays lazy in
``backends``, as JAX keeps it."""

import importlib
import pkgutil

import pytest

import k_llms_tpu


def _packages():
    names = ["k_llms_tpu"]
    for info in pkgutil.walk_packages(k_llms_tpu.__path__, "k_llms_tpu."):
        if info.ispkg:
            names.append(info.name)
    out = []
    for name in names:
        module = importlib.import_module(name)
        if hasattr(module, "__all__"):
            out.append((name, list(module.__all__)))
    return out


PACKAGES = _packages()


def test_every_jax_package_with_exports_is_covered():
    names = {name for name, _ in PACKAGES}
    for sub in ("reliability", "utils", "ops", "models", "backends", "parallel"):
        assert f"k_llms_tpu.{sub}" in names


@pytest.mark.parametrize("name,exports", PACKAGES, ids=[n for n, _ in PACKAGES])
def test_the_port_exports_the_jax_names(name, exports):
    port_name = "k_llms_tpu_torch" + name[len("k_llms_tpu"):]
    port = importlib.import_module(port_name)
    assert sorted(port.__all__) == sorted(exports)
    for export in exports:
        obj = getattr(port, export)
        assert obj is not None
        exec(f"from {port_name} import {export}", {})


def test_replica_set_stays_lazy():
    import subprocess
    import sys

    code = ("import sys, k_llms_tpu_torch.backends as b\n"
            "assert 'k_llms_tpu_torch.reliability.replicas' not in sys.modules\n"
            "from k_llms_tpu_torch.backends import ReplicaSet\n"
            "from k_llms_tpu_torch.reliability.replicas import ReplicaSet as R\n"
            "assert ReplicaSet is R\n")
    subprocess.run([sys.executable, "-c", code], check=True)
