"""The serve report: a metrics registry and the console report rendered
from it."""
