"""Launchers of the port: serving steps and the serve driver."""
