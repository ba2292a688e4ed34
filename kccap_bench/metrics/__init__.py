"""One reader per metric: ``read(artifacts)`` returns the metric's value,
or None where the run left nothing to read."""
