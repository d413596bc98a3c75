"""The entries that drive the port: one module for each entry a traffic mix names."""
