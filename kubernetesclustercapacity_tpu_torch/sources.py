"""Cluster-source resolution for the CLI.

Counterpart of ``kubernetesclustercapacity_tpu/sources.py``: one place owns
the rules for turning ``-snapshot``/``-semantics`` into a packed snapshot:

* ``.npz`` checkpoints carry the semantics they were packed with; an
  explicit conflicting request is an error (never silently mix packings);
* fixture ``.json`` re-packs under the requested semantics (default
  ``reference``).

The live-cluster source is not ported yet.
"""

from __future__ import annotations

import os

from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot,
    load_snapshot,
    snapshot_from_fixture,
)

__all__ = ["SourceError", "resolve_source"]


class SourceError(ValueError):
    """Unusable cluster source (missing file, semantics conflict)."""


def resolve_source(
    path: str,
    semantics: str | None,
    extended_resources: tuple[str, ...] = (),
) -> tuple[dict | None, ClusterSnapshot, str]:
    """Load a fixture/.npz source → ``(fixture|None, snapshot, semantics)``.

    ``semantics=None`` means "not explicitly requested": adopt the
    checkpoint's stored packing for ``.npz``, default ``reference``
    otherwise.  ``extended_resources`` names extra columns to pack from a
    fixture (strict semantics only — reference has no concept of them);
    a ``.npz`` checkpoint must already carry every requested column
    (columns cannot be re-derived without the raw objects).
    """
    extended_resources = tuple(extended_resources)
    if not os.path.exists(path):
        raise SourceError(f"snapshot file not found: {path}")
    if path.endswith(".npz"):
        snap = load_snapshot(path)
        if semantics is not None and semantics != snap.semantics:
            raise SourceError(
                f"snapshot {path} was packed with -semantics "
                f"{snap.semantics}; re-pack from a fixture to run {semantics}"
            )
        missing = sorted(set(extended_resources) - set(snap.extended))
        if missing:
            raise SourceError(
                f"snapshot {path} carries no extended column(s) {missing}; "
                "re-pack from a fixture with -extended-resources"
            )
        return None, snap, snap.semantics
    semantics = semantics or "reference"
    if extended_resources and semantics != "strict":
        # snapshot_from_fixture owns this rule; the pre-check rewraps it
        # as a SourceError so the CLI reports it like other source faults.
        raise SourceError(
            "extended resources require strict semantics (reference "
            "semantics has no extended-column concept)"
        )
    fixture = load_fixture(path)
    return (
        fixture,
        snapshot_from_fixture(
            fixture, semantics=semantics,
            extended_resources=extended_resources,
        ),
        semantics,
    )
