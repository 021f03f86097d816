"""Model configurations the port serves."""
