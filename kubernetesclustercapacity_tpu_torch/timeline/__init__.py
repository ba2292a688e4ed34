"""Capacity timeline (counterpart of ``kubernetesclustercapacity_tpu/timeline/``).

Only :mod:`.alerts` is ported so far: the ok → breached → recovered state
machine that the device-memory ledger's leak alert rides.  The
per-generation history, the watchlist and the node-set diff wait for a
later slice.
"""
