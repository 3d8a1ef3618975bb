"""Test and benchmark fixtures."""
