"""The yardstick's own arithmetic: traffic, counts, trace readers."""
