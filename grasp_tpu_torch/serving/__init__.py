"""Paged continuous-batching engines (plain and speculative) and the HTTP
front end of the port."""
