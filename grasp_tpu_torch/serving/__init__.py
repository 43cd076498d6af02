"""Paged continuous-batching engine and HTTP front end of the port."""
