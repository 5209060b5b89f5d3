"""Serving step builders."""
