"""The forecaster family of the port: leaf math, cells, GAT, GMM head."""
