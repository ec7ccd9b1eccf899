"""Recommender models of the port (counterparts of `repro.models.recsys`)."""
