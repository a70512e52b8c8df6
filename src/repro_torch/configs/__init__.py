"""Deployment configurations of the port (the Mez edge testbed)."""
