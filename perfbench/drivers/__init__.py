"""General generators: each reads a traffic file and drives the program."""
