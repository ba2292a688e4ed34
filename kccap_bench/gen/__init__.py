"""The traffic kinds, one module each, that turn a traffic file and a seed
into a plan of requests."""
