"""Deliberately-broken package for the device-purity rule (never imported).

The roots are declared the way the port declares its own: a module-level
``DEVICE_ROOTS`` literal, package-relative names.  The last entry names
no function and must be flagged where it is listed.
"""

DEVICE_ROOTS = (
    "bad_device.subsystem_root",
    "bad_device.lock_root",
    "bad_device.io_root",
    "bad_device.clock_root",
    "bad_device.random_root",
    "bad_device.sync_root",
    "bad_device.coercion_root",
    "bad_device.while_root",
    "bad_device.detour_root",
    "bad_device.boundary_root",
    "clean_device.clean_root",
    "clean_device.one_sync_per_call",
    "bad_device.renamed_away",  # expect: device-purity
)
