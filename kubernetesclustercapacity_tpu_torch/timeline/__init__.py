"""Capacity timeline (counterpart of ``kubernetesclustercapacity_tpu/timeline/``).

Ported so far: :mod:`.alerts`, the ok → breached → recovered state machine
that the device-memory ledger's leak alert rides, and :mod:`.diff`, the
node-set diff the audit log records generations with.  The
per-generation history and the watchlist wait for a later slice.
"""
