"""The benchmark's own tests: ``python3 -m pytest kccap_bench/tests -q``."""
