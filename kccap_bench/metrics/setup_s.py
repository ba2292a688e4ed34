"""Seconds from the run's start to the window's: the server process's
torch import, CUDA set-up, cluster build and packing, kernel loads (or
builds, on a checkout's first run), the warm requests, and in a churn
cell the first update, which builds the store."""


def read(artifacts):
    return artifacts["load"]["setup_s"]
