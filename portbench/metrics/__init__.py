"""One reader per metric, found by the metric's name: ``read(record)``
returns the value, or None where the run's record holds nothing to read
it from (the metric is then left out of the result line)."""
