"""Compiler passes ported so far: graph capture and the estimation pass."""
