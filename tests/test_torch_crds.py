"""The port's CRD manifests (``models/crds.py``) against the JAX package's.

* ``write_manifests`` into ``tmp_path`` writes the files of
  ``config/crds/`` byte for byte (the port never writes to
  ``config/``: its default directory is the JAX package's and the test
  passes its own).
* The cases of ``tests/test_crds.py`` run over the port's module, with
  its globals pointed at the port's (the on-disk case reads
  ``config/crds/``, which the port's ``MANIFEST_DIR`` names).
* Every generated manifest and every FTC's CRD equals the JAX
  package's, and ``install`` leaves the same store.
"""

import os
from pathlib import Path

import pytest

import test_crds as TC
from test_torch_status import run_both, run_method
from test_torch_sync import method_cases

from kubeadmiral_tpu.models import crds as jax_crds
from kubeadmiral_tpu.models.ftc import default_ftcs as jax_default_ftcs
from kubeadmiral_tpu.testing.fakekube import FakeKube as JaxKube
from kubeadmiral_tpu_torch.models import crds
from kubeadmiral_tpu_torch.models.ftc import default_ftcs
from kubeadmiral_tpu_torch.testing.fakekube import FakeKube

ROOT = Path(__file__).resolve().parent.parent


def test_manifests_written_byte_for_byte(tmp_path):
    pytest.importorskip("yaml")
    paths = crds.write_manifests(str(tmp_path))
    assert all(os.path.dirname(p) == str(tmp_path) for p in paths)
    written = {os.path.basename(p): Path(p).read_bytes() for p in paths}
    on_disk = {p.name: p.read_bytes() for p in (ROOT / "config" / "crds").glob("*.yaml")}
    assert written == on_disk


def test_manifest_dir_is_the_jax_packages():
    assert crds.MANIFEST_DIR == jax_crds.MANIFEST_DIR == str(ROOT / "config" / "crds")


def test_manifests_and_ftc_crds_equal_jax():
    assert crds.core_crds() == jax_crds.core_crds()
    assert [crds.crd_for_ftc(f) for f in default_ftcs()] == [
        jax_crds.crd_for_ftc(f) for f in jax_default_ftcs()
    ]
    mine, theirs = FakeKube("host"), JaxKube("host")
    assert crds.install(mine, default_ftcs()) == jax_crds.install(theirs, jax_default_ftcs())
    assert mine.dump() == theirs.dump()


CASES = method_cases(TC.TestCoreCrds, TC.TestFtcCrds)


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_crds_case(monkeypatch, cls, name):
    run_both(monkeypatch, (TC,), run_method(cls, name))
