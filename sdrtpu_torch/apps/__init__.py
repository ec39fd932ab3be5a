"""Receive pipelines."""
