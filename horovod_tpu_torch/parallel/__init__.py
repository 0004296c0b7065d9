"""Mesh spec, collectives and the data-parallel step of the port."""
