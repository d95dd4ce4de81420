"""Walkthroughs of the port's deployment surface."""
