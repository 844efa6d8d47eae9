"""Web service layer: the config service only."""
