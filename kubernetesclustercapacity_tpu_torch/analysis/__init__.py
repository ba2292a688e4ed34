"""Tooling over the repository's own artifacts.

Counterpart of ``kubernetesclustercapacity_tpu/analysis/``.  The port has
:mod:`.benchdiff` (``kccap-torch -bench-diff``), pure host code over the
committed bench JSON files.  The lint engine and the sanitizer of the JAX
package are not ported yet; this package imports nothing, so importing
:mod:`.benchdiff` costs nothing else.
"""
