"""The batched sweep engine of the port: lanes, metrics and the cell store."""
