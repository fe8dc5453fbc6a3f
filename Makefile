# Native codec build + sanitizer targets (SURVEY.md section 5: the
# reference relies on Rust's type system for thread safety; the C++
# ingest here gets ASAN/TSAN checks instead).

CODEC := ngs_barcode_count_tpu/io/_native/fastq_codec.cpp
SO    := ngs_barcode_count_tpu/io/_native/fastq_codec.so
HARNESS := ngs_barcode_count_tpu/io/_native/codec_harness.cpp

.PHONY: codec asan tsan sanitize test clean

codec: $(SO)

$(SO): $(CODEC)
	g++ -O3 -march=native -shared -fPIC -std=c++17 $(CODEC) -lz -o $(SO)

# Address/UB sanitizer run of the C harness over generated fixtures.
asan: $(CODEC) $(HARNESS)
	mkdir -p .build
	g++ -g -O1 -fsanitize=address,undefined -fno-omit-frame-pointer \
	  -std=c++17 $(CODEC) $(HARNESS) -lz -o .build/codec_asan
	python -m ngs_barcode_count_tpu.io._native.make_fixtures .build/codec_fix
	.build/codec_asan .build/codec_fix

# Thread sanitizer: the harness drives concurrent range readers the way
# io/parallel_ingest.py does.
tsan: $(CODEC) $(HARNESS)
	mkdir -p .build
	g++ -g -O1 -fsanitize=thread -std=c++17 $(CODEC) $(HARNESS) \
	  -lz -o .build/codec_tsan
	python -m ngs_barcode_count_tpu.io._native.make_fixtures .build/codec_fix
	.build/codec_tsan .build/codec_fix

sanitize: asan tsan

test:
	python -m pytest tests/ -x -q

clean:
	rm -f $(SO)
	rm -rf .build
