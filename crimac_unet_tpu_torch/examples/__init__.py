"""Walkthroughs of the port: onboarding, readers, samplers, serving and
deployment."""
