"""The runners a traffic mix's ``kind`` selects: serving or training."""
