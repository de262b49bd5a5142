#!/bin/sh
# Build the native minigeom shared library (no external dependencies).
set -e
cd "$(dirname "$0")"
g++ -O3 -shared -fPIC -Wall -o libminigeom.so minigeom.cpp
echo "built $(pwd)/libminigeom.so"
