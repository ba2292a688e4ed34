// kccap-client: compiled front-end CLI for the capacity service.
//
// The north-star boundary is "thin compiled front-end -> RPC -> Python/JAX
// service".  This is that front-end: it mirrors the reference CLI's six
// flags (same names, same defaults — src/KubeAPI/ClusterCapacity.go:50-62),
// frames a `fit` request in the service's length-prefixed JSON protocol,
// and prints the server-rendered report verbatim (all semantics, parsing
// included, live server-side so the two front-ends can never drift).
//
// Build:  g++ -O2 -std=c++17 -o kccap-client kccap_client.cc
// Usage:  kccap-client -server 127.0.0.1:7077 -cpuRequests=200m
//         -memRequests=250mb -replicas=10 [-output reference|json|table]
//
// Protocol frame: 4-byte big-endian length + UTF-8 JSON
// (see service/protocol.py).

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

static std::string json_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if ((unsigned char)c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

// Minimal real JSON scanner (cursor-based, grammar-driven — not a
// substring search, so json.dumps spacing/ordering changes cannot break
// it).  Covers the full value grammar the response can carry; only the
// pieces the client reads (top-level "ok"/"error", "result.report") are
// materialized, everything else is skipped structurally.
struct JsonScanner {
  const std::string& s;
  size_t p = 0;
  explicit JsonScanner(const std::string& doc) : s(doc) {}

  void ws() {
    while (p < s.size() && (s[p] == ' ' || s[p] == '\t' || s[p] == '\n' ||
                            s[p] == '\r'))
      p++;
  }
  bool lit(const char* l) {
    size_t n = strlen(l);
    if (s.compare(p, n, l) == 0) {
      p += n;
      return true;
    }
    return false;
  }

  // Parse a JSON string at the cursor (opening quote expected) into UTF-8,
  // combining UTF-16 surrogate pairs (json.dumps emits them for non-BMP
  // characters under ensure_ascii).
  bool parse_string(std::string* out) {
    ws();
    if (p >= s.size() || s[p] != '"') return false;
    p++;
    std::string result;
    while (p < s.size()) {
      char c = s[p];
      if (c == '"') {
        p++;
        if (out) *out = result;
        return true;
      }
      if (c == '\\' && p + 1 < s.size()) {
        char e = s[++p];
        switch (e) {
          case 'n': result += '\n'; break;
          case 't': result += '\t'; break;
          case 'r': result += '\r'; break;
          case 'b': result += '\b'; break;
          case 'f': result += '\f'; break;
          case '"': result += '"'; break;
          case '\\': result += '\\'; break;
          case '/': result += '/'; break;
          case 'u': {
            // Exactly four hex digits, validated by hand: sscanf("%4x")
            // would skip whitespace, accept signs/0x, and parse FEWER
            // than four digits — desynchronizing the scanner on
            // malformed input (the cursor advances by four regardless).
            auto hex4 = [this](size_t at, unsigned* out4) -> bool {
              unsigned v = 0;
              for (size_t k = 0; k < 4; ++k) {
                if (at + k >= s.size()) return false;
                char h = s[at + k];
                unsigned d;
                if (h >= '0' && h <= '9') d = (unsigned)(h - '0');
                else if (h >= 'a' && h <= 'f') d = 10u + (unsigned)(h - 'a');
                else if (h >= 'A' && h <= 'F') d = 10u + (unsigned)(h - 'A');
                else return false;
                v = (v << 4) | d;
              }
              *out4 = v;
              return true;
            };
            unsigned code = 0;
            if (!hex4(p + 1, &code)) return false;
            p += 4;
            if (code >= 0xD800 && code <= 0xDBFF) {
              if (p + 2 >= s.size() || s[p + 1] != '\\' || s[p + 2] != 'u')
                return false;
              unsigned low = 0;
              if (!hex4(p + 3, &low)) return false;
              if (low < 0xDC00 || low > 0xDFFF) return false;
              p += 6;
              code = 0x10000 + ((code - 0xD800) << 10) + (low - 0xDC00);
            }
            if (code < 0x80) {
              result += (char)code;
            } else if (code < 0x800) {  // 2-byte UTF-8
              result += (char)(0xC0 | (code >> 6));
              result += (char)(0x80 | (code & 0x3F));
            } else if (code < 0x10000) {  // 3-byte UTF-8
              result += (char)(0xE0 | (code >> 12));
              result += (char)(0x80 | ((code >> 6) & 0x3F));
              result += (char)(0x80 | (code & 0x3F));
            } else {  // 4-byte UTF-8
              result += (char)(0xF0 | (code >> 18));
              result += (char)(0x80 | ((code >> 12) & 0x3F));
              result += (char)(0x80 | ((code >> 6) & 0x3F));
              result += (char)(0x80 | (code & 0x3F));
            }
            break;
          }
          default: result += e;
        }
        p++;
      } else {
        result += c;
        p++;
      }
    }
    return false;  // unterminated string
  }

  // Skip any JSON value (string, number, object, array, literal).
  bool skip_value() {
    ws();
    if (p >= s.size()) return false;
    char c = s[p];
    if (c == '"') return parse_string(nullptr);
    if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      p++;
      int depth = 1;
      while (p < s.size() && depth) {
        ws();
        if (p >= s.size()) break;
        char d = s[p];
        if (d == '"') {
          if (!parse_string(nullptr)) return false;
        } else {
          if (d == open) depth++;
          if (d == close) depth--;
          p++;
        }
      }
      return depth == 0;
    }
    if (lit("true") || lit("false") || lit("null")) return true;
    // number
    size_t start = p;
    while (p < s.size() &&
           (isdigit((unsigned char)s[p]) || s[p] == '-' || s[p] == '+' ||
            s[p] == '.' || s[p] == 'e' || s[p] == 'E'))
      p++;
    return p > start;
  }

  // Walk an object's members at the cursor, invoking cb(key) positioned at
  // each value; cb must consume the value (or return false to abort).
  template <typename F>
  bool walk_object(F cb) {
    ws();
    if (p >= s.size() || s[p] != '{') return false;
    p++;
    ws();
    if (p < s.size() && s[p] == '}') {
      p++;
      return true;
    }
    while (p < s.size()) {
      std::string key;
      if (!parse_string(&key)) return false;
      ws();
      if (p >= s.size() || s[p] != ':') return false;
      p++;
      if (!cb(key)) return false;
      ws();
      if (p < s.size() && s[p] == ',') {
        p++;
        continue;
      }
      if (p < s.size() && s[p] == '}') {
        p++;
        return true;
      }
      return false;
    }
    return false;
  }
};

// Parsed response surface: ok flag, top-level error, result.report.
struct Response {
  bool ok = false;
  bool has_error = false, has_report = false;
  std::string error, report;
};

static bool parse_response(const std::string& doc, Response* r) {
  JsonScanner sc(doc);
  return sc.walk_object([&](const std::string& key) -> bool {
    if (key == "ok") {
      sc.ws();
      if (sc.lit("true")) {
        r->ok = true;
        return true;
      }
      if (sc.lit("false")) return true;
      return sc.skip_value();  // tolerate a non-bool "ok"
    }
    if (key == "error") {
      sc.ws();
      if (sc.p < sc.s.size() && sc.s[sc.p] == '"') {
        r->has_error = sc.parse_string(&r->error);
        return r->has_error;
      }
      return sc.skip_value();
    }
    if (key == "result") {
      sc.ws();
      if (sc.p < sc.s.size() && sc.s[sc.p] == '{') {
        return sc.walk_object([&](const std::string& rkey) -> bool {
          if (rkey == "report") {
            sc.ws();
            if (sc.p < sc.s.size() && sc.s[sc.p] == '"') {
              r->has_report = sc.parse_string(&r->report);
              return r->has_report;
            }
          }
          return sc.skip_value();
        });
      }
      return sc.skip_value();
    }
    return sc.skip_value();
  });
}

static bool send_all(int fd, const char* buf, size_t n) {
  while (n) {
    ssize_t w = write(fd, buf, n);
    if (w <= 0) return false;
    buf += w;
    n -= (size_t)w;
  }
  return true;
}

static bool recv_all(int fd, char* buf, size_t n) {
  while (n) {
    ssize_t r = read(fd, buf, n);
    if (r <= 0) return false;
    buf += r;
    n -= (size_t)r;
  }
  return true;
}

int main(int argc, char** argv) {
  std::string server = "127.0.0.1:7077";
  // Reference flag defaults (ClusterCapacity.go:57-61).
  std::string cpuRequests = "100m", cpuLimits = "200m";
  std::string memRequests = "100mb", memLimits = "200mb";
  std::string replicas = "1", output = "reference";
  // Optional shared bearer token: $KCCAP_AUTH_TOKEN or -token-file (never
  // argv — a -token flag would leak the secret via /proc/<pid>/cmdline).
  std::string token, token_file;
  if (const char* env = getenv("KCCAP_AUTH_TOKEN")) token = env;

  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    auto value = [&](const std::string& flag, std::string* dst) -> bool {
      if (a.rfind(flag + "=", 0) == 0) {
        *dst = a.substr(flag.size() + 1);
        return true;
      }
      if (a == flag && i + 1 < argc) {
        *dst = argv[++i];
        return true;
      }
      return false;
    };
    if (value("-server", &server) || value("-cpuRequests", &cpuRequests) ||
        value("-cpuLimits", &cpuLimits) || value("-memRequests", &memRequests) ||
        value("-memLimits", &memLimits) || value("-replicas", &replicas) ||
        value("-output", &output) || value("-token-file", &token_file))
      continue;
    if (a == "-h" || a == "-help" || a == "--help") {
      fprintf(stderr,
              "usage: kccap-client [-server host:port] [-cpuRequests v] "
              "[-cpuLimits v] [-memRequests v] [-memLimits v] [-replicas n] "
              "[-output reference|json|table] [-token-file path]\n"
              "       ($KCCAP_AUTH_TOKEN also supplies the token)\n");
      return 0;
    }
    fprintf(stderr, "unknown flag: %s\n", a.c_str());
    return 1;
  }

  if (!token_file.empty()) {
    FILE* f = fopen(token_file.c_str(), "rb");
    if (!f) {
      fprintf(stderr, "ERROR : cannot read token file %s\n",
              token_file.c_str());
      return 1;
    }
    char buf[4096];
    size_t n = fread(buf, 1, sizeof buf, f);
    fclose(f);
    token.assign(buf, n);
    while (!token.empty() &&
           (token.back() == '\n' || token.back() == '\r' ||
            token.back() == ' ' || token.back() == '\t'))
      token.pop_back();
    if (token.empty()) {
      fprintf(stderr, "ERROR : token file is empty\n");
      return 1;
    }
  }

  size_t colon = server.rfind(':');
  if (colon == std::string::npos) {
    fprintf(stderr, "ERROR : -server must be host:port\n");
    return 1;
  }
  std::string host = server.substr(0, colon);
  std::string port = server.substr(colon + 1);

  struct addrinfo hints = {}, *res = nullptr;
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), port.c_str(), &hints, &res) != 0 || !res) {
    fprintf(stderr, "ERROR : cannot resolve %s\n", server.c_str());
    return 1;
  }
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    fprintf(stderr, "ERROR : cannot connect to capacity service at %s\n",
            server.c_str());
    freeaddrinfo(res);
    return 1;
  }
  freeaddrinfo(res);

  std::string body = std::string("{\"op\":\"fit\"") +
      ",\"cpuRequests\":\"" + json_escape(cpuRequests) + "\"" +
      ",\"cpuLimits\":\"" + json_escape(cpuLimits) + "\"" +
      ",\"memRequests\":\"" + json_escape(memRequests) + "\"" +
      ",\"memLimits\":\"" + json_escape(memLimits) + "\"" +
      ",\"replicas\":\"" + json_escape(replicas) + "\"" +
      ",\"output\":\"" + json_escape(output) + "\"";
  if (!token.empty()) body += ",\"token\":\"" + json_escape(token) + "\"";
  body += "}";
  uint32_t len = htonl((uint32_t)body.size());
  if (!send_all(fd, (const char*)&len, 4) ||
      !send_all(fd, body.data(), body.size())) {
    fprintf(stderr, "ERROR : send failed\n");
    return 1;
  }

  uint32_t resp_len_be = 0;
  if (!recv_all(fd, (char*)&resp_len_be, 4)) {
    fprintf(stderr, "ERROR : no response\n");
    return 1;
  }
  uint32_t resp_len = ntohl(resp_len_be);
  if (resp_len > (64u << 20)) {
    fprintf(stderr, "ERROR : oversized response\n");
    return 1;
  }
  std::string resp(resp_len, '\0');
  if (!recv_all(fd, resp.data(), resp_len)) {
    fprintf(stderr, "ERROR : truncated response\n");
    return 1;
  }
  close(fd);

  Response parsed;
  if (!parse_response(resp, &parsed)) {
    fprintf(stderr, "ERROR : malformed response frame: %s\n", resp.c_str());
    return 1;
  }
  if (!parsed.ok) {
    if (parsed.has_error)
      fprintf(stderr, "ERROR : %s\n", parsed.error.c_str());
    else
      fprintf(stderr, "ERROR : %s\n", resp.c_str());
    return 1;
  }

  if (parsed.has_report) {
    fputs(parsed.report.c_str(), stdout);
  } else {
    fputs(resp.c_str(), stdout);  // json/table outputs arrive pre-rendered too
    fputc('\n', stdout);
  }
  return 0;
}
