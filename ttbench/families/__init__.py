"""How the harness drives the program for each family of configuration
files (``"family"`` in the file names the module)."""
