#!/bin/sh
# Build the native IO runtime: native/libframe_io.so
set -e
cd "$(dirname "$0")"
g++ -O3 -march=native -std=c++17 -shared -fPIC frame_io.cc -lz -lpthread \
    -o libframe_io.so
echo "built $(pwd)/libframe_io.so"
