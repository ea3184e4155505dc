"""Object-store staging (Grid_Cloud.pm equivalent).

The port's own copy of canu_tpu.pipeline.objectstore (no torch, no jax), with the same
results.

The reference abstracts shared-nothing clouds behind fetchFile/stashFile
and fetchStore/stashStore, tarring store directories for transfer
(Canu src/pipelines/canu/Grid_Cloud.pm:80-346), with a mock
client for tests (objectStore=TEST -> canu-object-store.pl).

Here the same four verbs target a pluggable backend:

  * LocalObjectStore — a directory acting as the bucket (the TEST mode);
  * GCSObjectStore — `gsutil`-shaped commands for real deployments
    (constructed lazily; raises clearly when the tool is unavailable,
    e.g. in this zero-egress build environment).

Store directories travel as .tar (same on-the-wire shape as the
reference) so a store stays one object.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tarfile


class ObjectStore:
    def stash_file(self, local: str, key: str) -> None:
        raise NotImplementedError

    def fetch_file(self, key: str, local: str) -> bool:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    # ---- store directories travel tarred (Grid_Cloud.pm:257-346) ----

    def stash_store(self, store_dir: str, key: str) -> None:
        tar = store_dir.rstrip("/") + ".stash.tar"
        with tarfile.open(tar, "w") as tf:
            tf.add(store_dir, arcname=os.path.basename(store_dir))
        try:
            self.stash_file(tar, key)
        finally:
            os.unlink(tar)

    def fetch_store(self, key: str, dest_parent: str) -> bool:
        os.makedirs(dest_parent, exist_ok=True)
        tar = os.path.join(dest_parent, ".fetch.tar")
        if not self.fetch_file(key, tar):
            return False
        try:
            with tarfile.open(tar) as tf:
                tf.extractall(dest_parent, filter="data")
        finally:
            os.unlink(tar)
        return True


class LocalObjectStore(ObjectStore):
    """Directory-backed bucket — the reference's objectStore=TEST mode."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.join(self.root, key.lstrip("/"))
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def stash_file(self, local: str, key: str) -> None:
        tmp = self._path(key) + ".WORKING"
        shutil.copyfile(local, tmp)
        os.replace(tmp, self._path(key))

    def fetch_file(self, key: str, local: str) -> bool:
        p = self._path(key)
        if not os.path.exists(p):
            return False
        shutil.copyfile(p, local)
        return True

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))


class GCSObjectStore(ObjectStore):
    """gsutil-backed bucket for real multi-host deployments."""

    def __init__(self, bucket: str, tool: str = "gsutil"):
        self.bucket = bucket.rstrip("/")
        self.tool = tool

    def _run(self, *args: str) -> subprocess.CompletedProcess:
        if shutil.which(self.tool) is None:
            raise RuntimeError(
                f"{self.tool} not available; use LocalObjectStore for tests"
            )
        return subprocess.run([self.tool, *args], capture_output=True, text=True)

    def stash_file(self, local: str, key: str) -> None:
        r = self._run("cp", local, f"{self.bucket}/{key}")
        if r.returncode != 0:
            raise RuntimeError(f"stash failed: {r.stderr}")

    def fetch_file(self, key: str, local: str) -> bool:
        return self._run("cp", f"{self.bucket}/{key}", local).returncode == 0

    def exists(self, key: str) -> bool:
        return self._run("ls", f"{self.bucket}/{key}").returncode == 0


def make_object_store(spec: str) -> ObjectStore | None:
    """Parse an objectStore config value: '' | TEST:<dir> | gs://bucket."""
    if not spec:
        return None
    if spec.upper().startswith("TEST:"):
        return LocalObjectStore(spec[5:])
    if spec.startswith("gs://"):
        return GCSObjectStore(spec)
    raise ValueError(f"unknown objectStore spec {spec!r}")
